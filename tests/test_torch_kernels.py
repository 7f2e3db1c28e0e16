"""The port's kernels against the JAX package's Pallas kernels.

On the CPU: each Pallas kernel, run in interpret mode as tests/test_kernels.py
runs it, is held against the port's plain PyTorch version (the path a CPU
tensor takes through the port's wrappers) on the same numpy inputs, in
float32.  On the card (marker ``cuda``, skipped elsewhere): each CUDA kernel
is held against its plain version.  The JAX side is imported by a fixture,
so that the card's tests run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import flash_prefill as t_flash  # noqa: E402
from repro_torch.kernels import gqa_decode as t_gqa  # noqa: E402
from repro_torch.kernels import moe_ffn as t_moe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as t_paged  # noqa: E402
from repro_torch.kernels import paged_mla_decode as t_mla  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402

TOL = 2e-5     # f32: both sides accumulate in f32, only the order differs

MOE_CASES = [
    # (E, C, D, F, block_c, block_f, act, weights, empty)
    (4, 3, 32, 128, 128, 64, "silu", "f32", "none"),      # decode-like C
    (2, 10, 64, 300, 8, 128, "gelu", "scaled", "none"),   # ragged C, F; scales
    (2, 5, 32, 64, 8, 64, "silu", "int8", "none"),        # int8 weights + scales
    (4, 6, 32, 64, 8, 64, "silu", "f32", "rows"),         # some rows all-zero
    (3, 5, 32, 128, 8, 64, "gelu", "scaled", "expert"),   # one expert empty
    (2, 4, 32, 64, 8, 64, "silu", "f32", "all"),          # every bucket empty
    (3, 40, 64, 136, 16, 64, "silu", "f32", "rows"),      # C past a row tile
]


def _moe_empty_rows(case, rng):
    """(E, C) bool: the bucket rows a case leaves all-zero, as capacity
    bucketing leaves the slots no token reached."""
    E, C, empty = case[0], case[1], case[8]
    rows = np.zeros((E, C), bool)
    if empty in ("rows", "expert"):
        rows = rng.random((E, C)) < 0.4
        rows[0, 0] = True
    if empty == "expert":
        rows[1] = True
    if empty == "all":
        rows[:] = True
    return rows


def _moe_inputs(case, seed):
    E, C, D, F, _, _, _, kind, _ = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (E, C, D)).astype(np.float32)
    x[_moe_empty_rows(case, rng)] = 0.0
    if kind == "int8":
        wi = rng.integers(-127, 128, (E, D, 2, F)).astype(np.int8)
        wo = rng.integers(-127, 128, (E, F, D)).astype(np.int8)
    else:
        wi = rng.normal(0, 0.1, (E, D, 2, F)).astype(np.float32)
        wo = rng.normal(0, 0.1, (E, F, D)).astype(np.float32)
    si = so = None
    if kind != "f32":
        si = (rng.random(E) * 0.01 + 0.001).astype(np.float32)
        so = (rng.random(E) * 0.01 + 0.001).astype(np.float32)
    return x, wi, wo, si, so


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas kernels (run in interpret mode)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import flash_prefill, gqa_decode, moe_ffn
    return dict(jnp=jnp, moe=moe_ffn.moe_ffn, gqa=gqa_decode.gqa_decode,
                flash=flash_prefill.flash_prefill)


def _t(a, device="cpu"):
    return None if a is None else torch.from_numpy(np.array(a)).to(device)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_plain_matches_pallas(pallas, case):
    jnp = pallas["jnp"]
    x, wi, wo, si, so = _moe_inputs(case, 0)
    _, _, _, _, bc, bf, act, _, _ = case
    want = pallas["moe"](jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
                         wi_scale=None if si is None else jnp.asarray(si),
                         wo_scale=None if so is None else jnp.asarray(so),
                         act=act, block_c=bc, block_f=bf, interpret=True)
    got = t_moe.moe_ffn(_t(x), _t(wi), _t(wo), _t(si), _t(so), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_moe_ffn_zero_rows_give_zero_outputs(pallas):
    """The premise of the CUDA kernel's empty-bucket skip: no bias, and
    act(0) = 0 for silu and gelu, so an all-zero xbuf row gives an exactly
    zero output row, in the port's plain version and in the JAX kernel."""
    jnp = pallas["jnp"]
    for case in MOE_CASES[3:]:
        x, wi, wo, si, so = _moe_inputs(case, 8)
        act = case[6]
        zero = ~x.any(-1)
        assert zero.any()
        want = np.asarray(pallas["moe"](
            jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
            wi_scale=None if si is None else jnp.asarray(si),
            wo_scale=None if so is None else jnp.asarray(so), act=act,
            block_c=case[4], block_f=case[5], interpret=True))
        got = ref.moe_ffn_ref(_t(x), _t(wi), _t(wo), _t(si), _t(so),
                              act=act).numpy()
        assert (want[zero] == 0).all() and (got[zero] == 0).all()
        assert (got[~zero] != 0).any(-1).all()


def test_moe_grouped_xbuf_rows_are_the_kept_assignments(monkeypatch):
    """At a decode shape (T 8, E 16, top-2) the bucket buffer that
    moe_grouped hands to the expert FFN is nonzero exactly at the (expert,
    slot) pairs of the kept assignments; every other row is zero, which is
    what the kernel's skip reads."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(),
                              num_experts=16, top_k=2)
    T, D, E, F = 8, cfg.d_model, cfg.num_experts, cfg.d_ff
    rng = np.random.default_rng(9)
    p = {"router": _t(rng.normal(0, 1, (D, E)).astype(np.float32)),
         "wi": _t(rng.normal(0, 0.1, (E, D, 2, F)).astype(np.float32)),
         "wo": _t(rng.normal(0, 0.1, (E, F, D)).astype(np.float32))}
    x = _t(rng.normal(0, 1, (T, D)).astype(np.float32))
    seen = []
    inner = moe.grouped_ffn

    def spy(cfg_, wi, wo, xbuf, *args, **kw):
        seen.append(xbuf.clone())
        return inner(cfg_, wi, wo, xbuf, *args, **kw)
    monkeypatch.setattr(moe, "grouped_ffn", spy)
    moe.moe_grouped(cfg, p, x, use_kernel=True)
    (xbuf,) = seen
    _, idx, _ = moe.route(cfg, p["router"], x)
    cap = xbuf.shape[1]
    slot, keep = moe.stage_bucket(idx.reshape(-1), E, cap)
    want = torch.zeros((E, cap), dtype=torch.bool)
    want[idx.reshape(-1)[keep], slot[keep]] = True
    assert torch.equal(xbuf.ne(0).any(-1), want)
    assert int(want.sum()) == int(keep.sum()) and 0 < want.sum() < E * cap


GQA_CASES = [
    # (B, H, Hkv, D, Dv, W, block_w, softcap, all_invalid_row)
    (2, 8, 2, 32, 32, 100, 128, 0.0, False),     # ragged W (one block)
    (2, 4, 1, 16, 24, 64, 16, 0.0, True),        # MQA, Dv != D, empty row
    (1, 4, 4, 16, 16, 96, 32, 30.0, False),      # MHA + softcap
    (1, 12, 1, 16, 16, 48, 16, 0.0, False),      # group of 12 heads
]


def _gqa_inputs(case, seed):
    B, H, Hkv, D, Dv, W, _, _, empty = case
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, W, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, W, Hkv, Dv)).astype(np.float32)
    valid = rng.random((B, W)) > 0.3
    if empty:
        valid[0] = False
    return q, k, v, valid


@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_decode_plain_matches_pallas(pallas, case):
    jnp = pallas["jnp"]
    q, k, v, valid = _gqa_inputs(case, 1)
    D, bw, cap = case[3], case[6], case[7]
    want = pallas["gqa"](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid), scale=D ** -0.5,
                         attn_softcap=cap, block_w=bw, interpret=True)
    got = t_gqa.gqa_decode(_t(q), _t(k), _t(v), _t(valid), scale=D ** -0.5,
                           attn_softcap=cap)
    for g, w in zip(got, want):            # o_unnorm, m, l
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)
    if case[8]:                            # empty row: all partials zero
        assert not got[0][0].any() and not got[1][0].any() \
            and not got[2][0].any()


FLASH_CASES = [
    # (B, S, Skv, H, Hkv, D, Dv, causal, window, softcap, block_q, block_k)
    (2, 40, 40, 4, 2, 16, 16, True, 0, 0.0, 16, 16),     # ragged S
    (1, 24, 24, 4, 1, 16, 24, True, 8, 0.0, 8, 8),       # window, Dv != D
    (1, 16, 16, 2, 2, 32, 32, True, 0, 30.0, 8, 8),      # softcap
    (1, 12, 24, 2, 2, 16, 16, False, 0, 0.0, 8, 8),      # cross, kv_len<Skv
    (2, 100, 100, 8, 2, 48, 32, True, 0, 0.0, 32, 32),   # D 48, group 4
    (1, 150, 150, 4, 1, 48, 32, True, 70, 0.0, 32, 32),  # window over a
]                                                        # 64-key tile edge


def _flash_inputs(case, seed):
    B, S, Skv, H, Hkv, D, Dv = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hkv, Dv)).astype(np.float32)
    lens = rng.integers(Skv // 2, Skv + 1, (B,)).astype(np.int32)
    return q, k, v, lens


def _has_context(case, lens):
    """(B, S) rows with at least one valid key; a row with none is a
    don't-care (the kernels give 0, the chunked reference mean(v))."""
    B, S, Skv = case[:3]
    causal, win = case[7], case[8]
    qp = np.arange(S)[None, :, None]
    kp = np.arange(Skv)[None, None, :]
    m = kp < lens[:, None, None]
    if causal:
        cm = kp <= qp
        if win:
            cm &= kp > qp - win
        m = m & cm
    return np.broadcast_to(m.any(-1), (B, S))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_prefill_plain_matches_pallas(pallas, case):
    jnp = pallas["jnp"]
    q, k, v, lens = _flash_inputs(case, 2)
    causal, win, cap, bq, bk = case[7:]
    want = pallas["flash"](jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=win, attn_softcap=cap,
                           kv_len=jnp.asarray(lens), block_q=bq, block_k=bk,
                           interpret=True)
    got = t_flash.flash_prefill(_t(q), _t(k), _t(v), _t(lens), causal=causal,
                                window=win, attn_softcap=cap)
    rows = _has_context(case, lens)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=TOL, atol=TOL)


PAGED_CASES = [
    # (B, H, Hkv, D, bt, MB, window, softcap)
    (3, 8, 2, 32, 16, 4, 0, 0.0),      # GQA; row 0 maps no block at all
    (2, 4, 1, 16, 4, 9, 6, 30.0),      # MQA, small blocks, window, softcap
    (2, 8, 8, 64, 8, 5, 0, 0.0),       # MHA
    (1, 16, 2, 128, 32, 3, 0, 0.0),    # group of 8, D 128, large blocks
    (2, 32, 2, 128, 16, 4, 0, 0.0),    # group of 16 (glm4's 32 / 2 heads)
    (2, 4, 2, 256, 8, 5, 20, 50.0),    # D 256 (gemma2), window, softcap
    (2, 8, 2, 32, 128, 2, 0, 0.0),     # blocks of 128 span two 64-tiles
    (3, 8, 2, 32, 12, 7, 0, 0.0),      # blocks of 12 straddle tiles
    (2, 48, 2, 64, 16, 3, 0, 0.0),     # group of 24: two head tiles
]
# the cases the float32 kernel body takes (H/Hkv <= 8, D <= 128)
F32_PAGED = [c for c in PAGED_CASES if c[1] // c[2] <= 8 and c[3] <= 128]


def paged_inputs(case, seed, trash=0.0):
    """A head-major arena whose rows map scattered physical blocks, with
    unmapped holes, positions past `pos` and empty slots, plus the fresh
    decode token.  Returns numpy arrays: q, k, v, slot_pos, page_table,
    pos, k_new, v_new.  The trash block (the last) holds `trash`."""
    B, H, Hkv, D, bt, MB = case[:6]
    rng = np.random.default_rng(seed)
    NB = B * MB + 2
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (Hkv, NB + 1, bt, D)).astype(np.float32)
    v = rng.normal(0, 1, (Hkv, NB + 1, bt, D)).astype(np.float32)
    k[:, NB] = v[:, NB] = trash
    slot_pos = rng.integers(-1, MB * bt, (NB + 1, bt)).astype(np.int32)
    pt = np.full((B, MB), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    perm = rng.permutation(NB)
    for b in range(B):
        n = int(rng.integers(1, MB * bt))        # tokens written so far
        pos[b] = n - 1 + int(rng.integers(0, 2))  # the query position
        for lb in range(-(-n // bt)):
            if (b == 0 and B > 2) or rng.random() < 0.15:
                continue                         # unmapped: masked whole
            pb = perm[b * MB + lb]
            pt[b, lb] = pb
            p = lb * bt + np.arange(bt)
            stale = rng.random(bt) < 0.2
            slot_pos[pb] = np.where(p < n, p, np.where(stale, p, -1))
    k_new = rng.normal(0, 1, (B, Hkv, D)).astype(np.float32)
    v_new = rng.normal(0, 1, (B, Hkv, D)).astype(np.float32)
    return q, k, v, slot_pos, pt, pos, k_new, v_new


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_fp32():
    """A CUDA device with TF32 off for the f32 plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


# f32: the kernel and its plain version differ only in summation order.
# bf16 outputs are rounded once from f32, so they may differ by one bf16
# ulp (2^-8 relative) where the two f32 sums straddle a rounding edge.
CARD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_cuda_matches_plain(cuda_fp32, case, dtype):
    """The kernel against its plain version; the all-zero bucket rows
    (which the bf16 body skips) give exact zeros.  int8 weights stay int8
    (the activations take `dtype`)."""
    dt = getattr(torch, dtype)
    x, wi, wo, si, so = _moe_inputs(case, 3)
    args = [_t(x, cuda_fp32).to(dt)] + [
        _t(w, cuda_fp32) if w.dtype == np.int8 else _t(w, cuda_fp32).to(dt)
        for w in (wi, wo)]
    scales = [_t(s, cuda_fp32) for s in (si, so)]
    got = t_moe.moe_ffn(*args, *scales, act=case[6])
    want = ref.moe_ffn_ref(*args, *scales, act=case[6])
    torch.cuda.synchronize()
    tol = atol = CARD_TOL[dtype]
    if case[7] == "int8" and dtype == "bfloat16":
        # int8 weights of |w| up to 127 give outputs of ~100: the bf16
        # hidden and output (as the torch.bmm chain keeps them) are then
        # off by a bf16 ulp of that scale, so the bound is on it
        atol = tol * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=atol)
    zero = torch.from_numpy(~x.any(-1))
    assert bool((got.cpu()[zero] == 0).all())


def _gqa_card_check(device, case, dtype, inputs):
    dt = getattr(torch, dtype)
    q, k, v, valid = inputs
    q, k, v = (_t(a, device).to(dt) for a in (q, k, v))
    valid = _t(valid, device)
    kw = dict(scale=case[3] ** -0.5, attn_softcap=case[7])
    got = t_gqa.gqa_decode(q, k, v, valid, **kw)
    want = ref.gqa_decode_ref(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):             # f32 partials on both sides
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_decode_cuda_matches_plain(cuda_fp32, case, dtype):
    _gqa_card_check(cuda_fp32, case, dtype, _gqa_inputs(case, 4))


# mixtral's served decode widths (G 4, D 128, a 512-slot ring), and a
# long ring with more chunks per row (W / 64) than the merge weighs at once
# (256); card only
GQA_SERVED_CASES = [
    # (B, H, Hkv, D, Dv, W, block_w, softcap, all_invalid_row)
    (3, 32, 8, 128, 128, 512, 128, 0.0, True),
    (3, 8, 2, 64, 64, 17000, 128, 0.0, True),
]


def _gqa_ring_inputs(case, seed):
    """A dense ring mid-serve: each row's valid slots are one run of
    consecutive slots that wraps past the ring's end (not a prefix), and
    row 0 holds none."""
    B, H, Hkv, D, Dv, W = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, W, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, W, Hkv, Dv)).astype(np.float32)
    valid = np.zeros((B, W), bool)
    for b in range(1, B):
        n = int(rng.integers(W // 4, W - 1))
        start = int(rng.integers(W - n + 1, W))     # the run wraps
        valid[b, (start + np.arange(n)) % W] = True
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GQA_SERVED_CASES)
def test_gqa_decode_cuda_served_ring(cuda_fp32, case, dtype):
    """Over a ring whose valid slots wrap; the row with no valid slot gives
    all-zero partials."""
    inputs = _gqa_ring_inputs(case, 11)
    assert inputs[3][1:].any(-1).all() and not inputs[3][0].any()
    ring = inputs[3][1:]                     # wrapped: both ends valid
    assert ring[:, 0].all() and ring[:, -1].all() and not ring.all()
    got = _gqa_card_check(cuda_fp32, case, dtype, inputs)
    assert not any(bool(t[0].any()) for t in got)


@pytest.mark.cuda
def test_gqa_decode_cuda_wide_rows(cuda_fp32):
    """The merge of the decode kernels over rows wider than one pass of its
    block (Dv 640 > 4 * 128 columns) and over more chunks than it weighs
    at once (17000 / 64 > 256): float32, whose body takes any Dv."""
    case = (2, 4, 2, 32, 640, 17000, 128, 0.0, True)
    _gqa_card_check(cuda_fp32, case, "float32", _gqa_ring_inputs(case, 13))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GQA_CASES + GQA_SERVED_CASES[:1])
def test_gqa_decode_cuda_int8_matches_plain(cuda_fp32, case, dtype):
    """An int8 ring (``kvcache.quantize_kv``) with queries of `dtype`: the
    kernel reads the int8 rows and folds the scales in; against the plain
    version on the same int8 ring, f32 partials within 1e-4."""
    dt = getattr(torch, dtype)
    q, k, v, valid = (_gqa_ring_inputs(case, 15) if case[5] >= 512
                      else _gqa_inputs(case, 14))
    ring = kvcache.quantize_kv(_t(k, cuda_fp32), _t(v, cuda_fp32))
    assert ring["k"].dtype == torch.int8
    q, valid = _t(q, cuda_fp32).to(dt), _t(valid, cuda_fp32)
    kw = dict(scale=case[3] ** -0.5, attn_softcap=case[7],
              k_scale=ring["k_scale"], v_scale=ring["v_scale"])
    before = t_gqa.gqa_decode.launches
    got = t_gqa.gqa_decode(q, ring["k"], ring["v"], valid, **kw)
    want = ref.gqa_decode_ref(q, ring["k"], ring["v"], valid, **kw)
    torch.cuda.synchronize()
    assert t_gqa.gqa_decode.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    if case[8]:                            # a row with no valid slot
        assert not any(bool(t[0].any()) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_prefill_cuda_matches_plain(cuda_fp32, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v, lens = _flash_inputs(case, 5)
    causal, win, cap = case[7:10]
    args = [_t(a, cuda_fp32).to(dt) for a in (q, k, v)]
    kl = _t(lens, cuda_fp32)
    got = t_flash.flash_prefill(*args, kl, causal=causal, window=win,
                                attn_softcap=cap)
    want = ref.flash_prefill_ref(*args, kl, causal=causal, window=win,
                                 attn_softcap=cap)
    torch.cuda.synchronize()
    rows = torch.from_numpy(np.ascontiguousarray(_has_context(case, lens)))
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(got.float().cpu()[rows],
                               want.float().cpu()[rows], rtol=tol, atol=tol)


FLASH_WIDE_CASES = [
    # (B, S, Skv, H, Hkv, D, Dv, causal, window, softcap): the wide body
    (1, 300, 300, 8, 4, 256, 256, True, 100, 50.0),   # gemma2's heads
    (2, 130, 130, 2, 1, 256, 256, True, 0, 0.0),      # ragged, kv_len
    (1, 96, 96, 4, 2, 200, 136, True, 40, 30.0),      # padded to 256
    (1, 64, 80, 2, 2, 128, 256, False, 0, 0.0),       # Dv > 128, cross
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_WIDE_CASES)
def test_flash_prefill_cuda_wide_heads_match_plain(cuda_fp32, case):
    """bf16 flash_prefill at D or Dv past 192 / 128 (gemma2's D = Dv =
    256): the wide tensor-core body, Q reloaded from shared memory,
    against the plain version with window and softcap, within 1e-2."""
    q, k, v, lens = _flash_inputs(case, 7)
    causal, win, cap = case[7:10]
    args = [_t(a, cuda_fp32).to(torch.bfloat16) for a in (q, k, v)]
    kl = _t(lens, cuda_fp32)
    before = t_flash.flash_prefill.launches
    got = t_flash.flash_prefill(*args, kl, causal=causal, window=win,
                                attn_softcap=cap)
    want = ref.flash_prefill_ref(*args, kl, causal=causal, window=win,
                                 attn_softcap=cap)
    torch.cuda.synchronize()
    assert t_flash.flash_prefill.launches == before + 1
    rows = torch.from_numpy(np.ascontiguousarray(_has_context(case, lens)))
    tol = CARD_TOL["bfloat16"]
    torch.testing.assert_close(got.float().cpu()[rows],
                               want.float().cpu()[rows], rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [100, 0])
def test_flash_prefill_cuda_wide_softcap_saturated(cuda_fp32, window):
    """The wide body's softcap where it saturates: gemma2's heads and cap,
    q drawn with std 32 so that at the scale 1/16 the scores spread with
    std 32 and about 12 % of them pass the cap of 50.  With and without
    the softcap the kernel holds to the plain version within 1e-2, and the
    two outputs differ by far more than that, so the check sees the
    softcap."""
    case = (1, 300, 300, 8, 4, 256, 256, True, window, 50.0)
    q, k, v, lens = _flash_inputs(case, 11)
    args = [_t(a, cuda_fp32).to(torch.bfloat16)
            for a in (q * 32, k, v)]
    kl = _t(lens, cuda_fp32)
    rows = torch.from_numpy(np.ascontiguousarray(_has_context(case, lens)))
    tol = CARD_TOL["bfloat16"]
    outs = []
    for cap in (50.0, 0.0):
        kw = dict(causal=True, window=window, attn_softcap=cap,
                  scale=1 / 16)
        got = t_flash.flash_prefill(*args, kl, **kw)
        want = ref.flash_prefill_ref(*args, kl, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float().cpu()[rows],
                                   want.float().cpu()[rows], rtol=tol,
                                   atol=tol)
        outs.append(got.float().cpu()[rows])
    assert (outs[0] - outs[1]).abs().max() > 50 * tol


def unmap_fresh_block(inputs, row):
    """Unmap the logical block that `row`'s fresh token falls in: the
    scatter sends the token to the trash block, and attention masks it."""
    q, k, v, sp, pt, pos, kn, vn = inputs
    bt, MB = sp.shape[1], pt.shape[1]
    pt = pt.copy()
    pt[row, int(pos[row]) % (MB * bt) // bt] = -1
    return q, k, v, sp, pt, pos, kn, vn


def paged_served_inputs(full, seed, trash=0.0, B=4):
    """mixtral's served decode widths over a paged arena (H 32 / Hkv 8,
    D 128, blocks of 16, 64 a row), the physical blocks scattered.  Mid-
    serve (`full` False): row 0 maps nothing, the others have written
    128..703 positions and map the blocks covering them and the fresh
    token's.  Full: every row maps all 64 blocks and the fresh token takes
    the ring's last position.  Returns numpy arrays as ``paged_inputs``."""
    H, Hkv, D, bt, MB = 32, 8, 128, 16, 64
    rng = np.random.default_rng(seed)
    NB = B * MB + 2
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (Hkv, NB + 1, bt, D)).astype(np.float32)
    v = rng.normal(0, 1, (Hkv, NB + 1, bt, D)).astype(np.float32)
    k[:, NB] = v[:, NB] = trash
    slot_pos = np.full((NB + 1, bt), -1, np.int32)
    pt = np.full((B, MB), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    perm = rng.permutation(NB)
    for b in range(B):
        n = MB * bt - 1 if full else (0 if b == 0 else
                                      int(rng.integers(128, 704)))
        pos[b] = n
        for lb in range(-(-(n + 1) // bt) if n else 0):
            pt[b, lb] = perm[b * MB + lb]
            p = lb * bt + np.arange(bt)
            slot_pos[pt[b, lb]] = np.where(p < n, p, -1)
    k_new = rng.normal(0, 1, (B, Hkv, D)).astype(np.float32)
    v_new = rng.normal(0, 1, (B, Hkv, D)).astype(np.float32)
    return q, k, v, slot_pos, pt, pos, k_new, v_new


def _paged_on(inputs, device, dt, int8=False):
    """The inputs on the card; `int8`: the arena and the fresh token
    quantized (``kvcache.quantize_kv``), the trash block's scales carried
    over from its values (NaN stays NaN)."""
    q, k, v, sp, pt, pos, kn, vn = inputs
    if int8:
        trash = float(k[0, -1, 0, 0])
        k, v = np.nan_to_num(k), np.nan_to_num(v)
        cache = kvcache.quantize_kv(_t(k, device), _t(v, device))
        for name in ("k_scale", "v_scale"):
            cache[name][:, -1] = trash
        new = kvcache.quantize_kv(_t(kn[:, None], device),
                                  _t(vn[:, None], device))
        q = _t(q, device).to(dt)
    else:
        q, k, v, kn, vn = (_t(a, device).to(dt) for a in (q, k, v, kn, vn))
        cache = {"k": k, "v": v}
        new = {"k": kn[:, None], "v": vn[:, None]}
    cache.update(slot_pos=_t(sp, device), page_table=_t(pt, device))
    return q, cache, _t(pos, device), new


def _paged_card_check(device, dtype, make, kw, int8=False):
    """The kernel on an arena whose trash block is NaN (an int8 arena: its
    trash scales) against the plain version on the same arena with a zero
    trash block (the plain version reads the trash for unmapped blocks and
    masks it), unfused and fused; then fused against write-then-attend,
    both through the kernel, bit for bit, and the kernel's arena scatter
    against the plain one's.  make(trash) gives the numpy inputs.  Returns
    the fused partials."""
    dt = getattr(torch, dtype)
    q, nan_c, pos, new = _paged_on(make(np.nan), device, dt, int8)
    _, zero_c, _, _ = _paged_on(make(0.0), device, dt, int8)
    got = ops.paged_gqa_decode(q, nan_c, pos, **kw)
    want = ops.paged_gqa_decode(q, zero_c, pos, impl="ref", **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    fused = ops.paged_gqa_decode_fused(q, nan_c, new, pos, **kw)
    want = ops.paged_gqa_decode_fused(q, zero_c, new, pos, impl="ref", **kw)
    for g, w in zip(fused, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    after = ops.paged_gqa_decode(q, nan_c, pos, **kw)   # over the scatter
    torch.cuda.synchronize()
    for g, w in zip(fused, after):
        assert torch.equal(g, w)
    nb = nan_c["slot_pos"].shape[0] - 1                  # trash excluded
    for name in ("k", "v") + (("k_scale", "v_scale") if int8 else ()):
        assert torch.equal(nan_c[name][:, :nb], zero_c[name][:, :nb])
    assert torch.equal(nan_c["slot_pos"][:nb], zero_c["slot_pos"][:nb])
    assert t_paged.paged_gqa_decode.launches >= 3
    return fused


def _paged_kw(case):
    return dict(scale=case[3] ** -0.5, window=case[6], attn_softcap=case[7])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_gqa_decode_cuda_matches_plain(cuda_fp32, case, dtype):
    """The checks of ``_paged_card_check``; a shape the float32 body does
    not take raises, naming its limits."""
    if dtype == "float32" and case not in F32_PAGED:
        q, cache, pos, _ = _paged_on(paged_inputs(case, 6), cuda_fp32,
                                     torch.float32)
        with pytest.raises(ValueError, match="float32 kernel takes"):
            ops.paged_gqa_decode(q, cache, pos, **_paged_kw(case))
        return
    _paged_card_check(cuda_fp32, dtype,
                      lambda trash: paged_inputs(case, 6, trash),
                      _paged_kw(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (c, d) for c in PAGED_CASES[:1] + PAGED_CASES[5:]
    for d in ("float32", "bfloat16") if d == "bfloat16" or c in F32_PAGED])
def test_paged_gqa_decode_cuda_fresh_block_unmapped(cuda_fp32, case, dtype):
    """Row 1's fresh token falls in an unmapped block: the kernel masks it
    (its scatter goes to the trash block, which stays unread)."""
    _paged_card_check(
        cuda_fp32, dtype,
        lambda trash: unmap_fresh_block(paged_inputs(case, 8, trash), 1),
        _paged_kw(case))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [False, True], ids=["mid_serve", "full"])
def test_paged_gqa_decode_cuda_served_shape(cuda_fp32, full, dtype):
    """The checks of ``_paged_card_check`` at mixtral's served widths,
    mid-serve (row 0 maps nothing: all-zero partials) and with all 64
    blocks of every row mapped."""
    fused = _paged_card_check(
        cuda_fp32, dtype, lambda trash: paged_served_inputs(full, 12, trash),
        dict(scale=128 ** -0.5))
    assert full or not any(bool(t[0].any()) for t in fused)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (c, d) for c in PAGED_CASES + ["served"]
    for d in ("float32", "bfloat16")
    if d == "bfloat16" or c == "served" or c in F32_PAGED])
def test_paged_gqa_decode_cuda_int8(cuda_fp32, case, dtype):
    """The checks of ``_paged_card_check`` over an int8 arena (the fused
    form's fresh int8 rows and scales included), and at mixtral's served
    widths mid-serve."""
    if case == "served":
        def make(trash):
            return paged_served_inputs(False, 12, trash)
        kw = dict(scale=128 ** -0.5)
    else:
        def make(trash):
            return paged_inputs(case, 16, trash)
        kw = _paged_kw(case)
    _paged_card_check(cuda_fp32, dtype, make, kw, int8=True)


MLA_CASES = [
    # (B, H, lat, dr, bt, MB)
    (3, 4, 32, 8, 16, 4),       # the DeepSeek smoke's widths; row 0 empty
    (2, 4, 16, 8, 4, 9),        # small blocks
    (2, 8, 64, 16, 8, 5),
    (2, 20, 128, 32, 16, 3),    # a head group past 16 heads
]


def mla_inputs(case, seed, trash=0.0):
    """A latent arena laid out as ``paged_inputs`` lays out the GQA arena,
    plus the fresh decode latents.  Returns numpy arrays: qcat, ckv, kr,
    slot_pos, page_table, pos, ckv_new, kr_new.  The trash block (the
    last) holds `trash`."""
    B, H, lat, dr, bt, MB = case
    rng = np.random.default_rng(seed)
    NB = B * MB + 2
    qcat = rng.normal(0, 1, (B, H, lat + dr)).astype(np.float32)
    ckv = rng.normal(0, 1, (NB + 1, bt, lat)).astype(np.float32)
    kr = rng.normal(0, 1, (NB + 1, bt, dr)).astype(np.float32)
    ckv[NB] = kr[NB] = trash
    slot_pos = rng.integers(-1, MB * bt, (NB + 1, bt)).astype(np.int32)
    pt = np.full((B, MB), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    perm = rng.permutation(NB)
    for b in range(B):
        n = int(rng.integers(1, MB * bt))        # tokens written so far
        pos[b] = n - 1 + int(rng.integers(0, 2))  # the query position
        for lb in range(-(-n // bt)):
            if (b == 0 and B > 2) or rng.random() < 0.15:
                continue                         # unmapped: masked whole
            pb = perm[b * MB + lb]
            pt[b, lb] = pb
            p = lb * bt + np.arange(bt)
            stale = rng.random(bt) < 0.2
            slot_pos[pb] = np.where(p < n, p, np.where(stale, p, -1))
    ckv_new = rng.normal(0, 1, (B, lat)).astype(np.float32)
    kr_new = rng.normal(0, 1, (B, dr)).astype(np.float32)
    return qcat, ckv, kr, slot_pos, pt, pos, ckv_new, kr_new


def _mla_on(case, seed, device, dt, trash):
    q, ckv, kr, sp, pt, pos, cn, rn = mla_inputs(case, seed, trash)
    q, ckv, kr, cn, rn = (_t(a, device).to(dt) for a in (q, ckv, kr, cn, rn))
    cache = {"ckv": ckv, "kr": kr, "slot_pos": _t(sp, device),
             "page_table": _t(pt, device)}
    return q, cache, _t(pos, device), {"ckv": cn[:, None], "kr": rn[:, None]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_CASES)
def test_paged_mla_decode_cuda_matches_plain(cuda_fp32, case, dtype):
    """As the paged GQA case: the kernel on a NaN trash block against the
    plain version on a zero one, unfused and fused; fused against
    write-then-attend through the kernel, bit for bit; the arena scatter
    against the plain one's."""
    _mla_card_check(cuda_fp32, case, dtype)


# DeepSeek-V3's served widths (128 heads, lat 512, dr 64, blocks of 16),
# and a long context: a page table wider than 1024 blocks, more chunks per
# row than the merge weighs at once (256); card only
MLA_SERVED_CASES = [
    # (B, H, lat, dr, bt, MB)
    (3, 128, 512, 64, 16, 6),   # row 0 maps nothing
    (2, 16, 512, 64, 16, 1100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MLA_SERVED_CASES)
def test_paged_mla_decode_cuda_served_widths(cuda_fp32, case, dtype):
    """The checks of the case above at the served widths and over a long
    context."""
    _mla_card_check(cuda_fp32, case, dtype)


def _mla_card_check(cuda_fp32, case, dtype):
    dt = getattr(torch, dtype)
    kw = dict(scale=(case[2] + case[3]) ** -0.5)
    q, nan_c, pos, new = _mla_on(case, 7, cuda_fp32, dt, np.nan)
    _, zero_c, _, _ = _mla_on(case, 7, cuda_fp32, dt, 0.0)
    got = ops.paged_mla_decode(q, nan_c, pos, **kw)
    want = ops.paged_mla_decode(q, zero_c, pos, impl="ref", **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    fused = ops.paged_mla_decode_fused(q, nan_c, new, pos, **kw)
    want = ops.paged_mla_decode_fused(q, zero_c, new, pos, impl="ref", **kw)
    for g, w in zip(fused, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    after = ops.paged_mla_decode(q, nan_c, pos, **kw)   # over the scatter
    torch.cuda.synchronize()
    for g, w in zip(fused, after):
        assert torch.equal(g, w)
    nb = nan_c["slot_pos"].shape[0] - 1                  # trash excluded
    for name in ("ckv", "kr", "slot_pos"):
        assert torch.equal(nan_c[name][:nb], zero_c[name][:nb])
    assert t_mla.paged_mla_decode.launches >= 3
