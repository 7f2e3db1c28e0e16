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
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-5     # f32: both sides accumulate in f32, only the order differs

MOE_CASES = [
    # (E, C, D, F, block_c, block_f, act, weights)
    (4, 3, 32, 128, 128, 64, "silu", "f32"),      # decode-like C
    (2, 10, 64, 300, 8, 128, "gelu", "scaled"),   # ragged C and F, scales
    (2, 5, 32, 64, 8, 64, "silu", "int8"),        # int8 weights + scales
]


def _moe_inputs(case, seed):
    E, C, D, F, _, _, _, kind = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (E, C, D)).astype(np.float32)
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
    _, _, _, _, bc, bf, act, _ = case
    want = pallas["moe"](jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
                         wi_scale=None if si is None else jnp.asarray(si),
                         wo_scale=None if so is None else jnp.asarray(so),
                         act=act, block_c=bc, block_f=bf, interpret=True)
    got = t_moe.moe_ffn(_t(x), _t(wi), _t(wo), _t(si), _t(so), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


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
]


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
@pytest.mark.parametrize("case", [c for c in MOE_CASES if c[7] != "int8"])
def test_moe_ffn_cuda_matches_plain(cuda_fp32, case, dtype):
    dt = getattr(torch, dtype)
    x, wi, wo, si, so = _moe_inputs(case, 3)
    args = [_t(a, cuda_fp32).to(dt) for a in (x, wi, wo)]
    scales = [_t(s, cuda_fp32) for s in (si, so)]
    got = t_moe.moe_ffn(*args, *scales, act=case[6])
    want = ref.moe_ffn_ref(*args, *scales, act=case[6])
    torch.cuda.synchronize()
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_decode_cuda_matches_plain(cuda_fp32, case, dtype):
    dt = getattr(torch, dtype)
    q, k, v, valid = _gqa_inputs(case, 4)
    q, k, v = (_t(a, cuda_fp32).to(dt) for a in (q, k, v))
    valid = _t(valid, cuda_fp32)
    kw = dict(scale=case[3] ** -0.5, attn_softcap=case[7])
    got = t_gqa.gqa_decode(q, k, v, valid, **kw)
    want = ref.gqa_decode_ref(q, k, v, valid, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):             # f32 partials on both sides
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


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
