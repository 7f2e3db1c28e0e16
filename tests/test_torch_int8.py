"""int8 KV and int8 expert weights in the port against the JAX package.

  * Quantization: ``kvcache.quantize_kv`` gives the JAX package's int8
    values and f32 scales bit for bit (half-to-even rounding included).
  * Kernels' plain versions: the int8 dense-ring and paged decodes (the
    path a CPU tensor takes through the kernel wrappers) against the
    Pallas kernels' int8 branch in interpret mode, partials within 1e-5,
    at blocks of 4, 8 and 16, fused and unfused; the fused int8 form
    against write-then-attend bit for bit; the int8 arena's layout.
  * Params: the port's own draw of int8 experts, a (layer, expert)
    matrix at a time, in the JAX package's layout.
  * Model: ``moe_grouped`` with int8 experts, and float32 logits within
    1e-4 of the JAX package's for qwen2.5-3b smoke with int8 KV (prefill
    and three decodes over the dense ring and over a paged arena, and
    chunked prefill) and for mixtral smoke with int8 experts and int8 KV;
    the quantization budget of ``test_serve_consistency.py`` (int8-KV
    decode against teacher forcing); the expert-paged int8 forward of
    ``test_paging.py`` (the scales ride in the shared span).
  * Engine: transcripts, slot histories, ``kv_traffic()`` and
    ``weight_traffic()`` equal the JAX engine's with int8 KV over the
    dense ring and over the paged arena at r_c 0.25 (the workload of
    ``test_kv_paging.py::test_int8_kv_paged_matches_dense``), and with
    int8 experts and int8 KV resident, expert-paged at r_w 0.25 in
    lockstep and in windows, and with both offload ratios at once.

The JAX engines run with their watchdog and degradation ladder off, with
``offload.pinned_host_sharding`` patched to None from here (as in
``test_torch_paged.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.core import paging as jax_paging  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import paging  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.serving import steps  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import SlotState  # noqa: E402
from test_torch_kernels import PAGED_CASES, paged_inputs  # noqa: E402

PART_TOL = 1e-5   # f32 partials: both sides sum in f32, in another order
TOL = 1e-4        # f32 logits through several layers


def _cfg(get, arch, **kw):
    return dataclasses.replace(get(arch).smoke(), dtype="float32", **kw)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ quantization

def test_quantize_kv_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    k = rng.normal(0, 3, (2, 7, 3, 16)).astype(np.float32)
    v = rng.normal(0, 0.01, (2, 7, 3, 16)).astype(np.float32)
    k[0, 0, 0] = 0.0                       # an all-zero row: scale 1e-8
    # a row whose scale is 1: 2.5, -3.5, 0.5 round half to even
    k[1, 2, 1] = 0.0
    k[1, 2, 1, :4] = (127.0, 2.5, -3.5, 0.5)
    want = jax_kvcache.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    got = kvcache.quantize_kv(_t(k), _t(v))
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        w = np.asarray(want[name])
        assert a.numpy().dtype == w.dtype
        np.testing.assert_array_equal(a.numpy(), w, err_msg=name)
    assert got["k"][1, 2, 1, :4].tolist() == [127, 2, -4, 0]
    for a, b in zip(kvcache.dequantize_kv(got),
                    jax_kvcache.dequantize_kv(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------ the kernels' plain versions

@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_int8_gqa_decode_plain_matches_pallas(softcap):
    from repro.kernels.gqa_decode import gqa_decode as pallas_gqa
    rng = np.random.default_rng(1)
    B, H, Hkv, D, W = 3, 8, 2, 32, 64
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    kv = jax_kvcache.quantize_kv(
        jnp.asarray(rng.normal(0, 1, (B, W, Hkv, D)), jnp.float32),
        jnp.asarray(rng.normal(0, 1, (B, W, Hkv, D)), jnp.float32))
    valid = rng.random((B, W)) < 0.6
    valid[1] = False                             # no valid slot in row 1
    kw = dict(scale=D ** -0.5, attn_softcap=softcap)
    want = pallas_gqa(jnp.asarray(q), kv["k"], kv["v"], jnp.asarray(valid),
                      k_scale=kv["k_scale"], v_scale=kv["v_scale"],
                      block_w=32, interpret=True, **kw)
    tkv = {n: _t(a) for n, a in kv.items()}
    got = ops.gqa_decode(_t(q), tkv["k"], tkv["v"], _t(valid),
                         k_scale=tkv["k_scale"], v_scale=tkv["v_scale"], **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PART_TOL,
                                   atol=PART_TOL)


def _int8_caches(case, seed):
    """``paged_inputs``' arena and fresh token, quantized per (head,
    position) as ``quantize_kv`` does, for both packages."""
    q, k, v, sp, pt, pos, kn, vn = paged_inputs(case, seed)
    arena = jax_kvcache.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    new = jax_kvcache.quantize_kv(jnp.asarray(kn[:, None]),
                                  jnp.asarray(vn[:, None]))
    jc = dict(arena, slot_pos=jnp.asarray(sp), page_table=jnp.asarray(pt))
    tc = {n: _t(a) for n, a in jc.items()}
    return q, pos, new, jc, tc


# blocks of 16 (row 0 maps nothing), of 4 (window, softcap) and of 8 (MHA)
INT8_PAGED = [PAGED_CASES[0], PAGED_CASES[1], PAGED_CASES[2]]


@pytest.mark.parametrize("case", INT8_PAGED, ids=["bt16", "bt4", "bt8"])
def test_int8_paged_decode_plain_matches_pallas(case):
    """Unfused and fused, against the Pallas kernel's int8 branch in
    interpret mode; the fused form's scatter (scales included) equals the
    JAX one exactly."""
    q, pos, new, jc, tc = _int8_caches(case, 2)
    kw = dict(scale=case[3] ** -0.5, window=case[6], attn_softcap=case[7])
    jq, jpos = jnp.asarray(q), jnp.asarray(pos)
    want = jax_ops.paged_gqa_decode(jq, jc, jpos, impl="interpret", **kw)
    got = ops.paged_gqa_decode(_t(q), tc, _t(pos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PART_TOL,
                                   atol=PART_TOL)
    want, jcache = jax_ops.paged_gqa_decode_fused(jq, jc, new, jpos,
                                                  impl="interpret", **kw)
    got = ops.paged_gqa_decode_fused(_t(q), tc, {n: _t(a)
                                                 for n, a in new.items()},
                                     _t(pos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PART_TOL,
                                   atol=PART_TOL)
    for name in ("k", "v", "k_scale", "v_scale", "slot_pos"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jcache[name]))


@pytest.mark.parametrize("case", PAGED_CASES)
def test_int8_fused_equals_write_then_attend(case):
    """The fused int8 form (the fresh rows and their scales merged into
    the gathered view, the arena scattered after) against the scatter
    followed by the unfused plain version, bit for bit
    (``test_arena_layout.py``'s int8 case)."""
    q, pos, new, _, tc = _int8_caches(case, 3)
    _, _, _, _, tc2 = _int8_caches(case, 3)
    kw = dict(scale=case[3] ** -0.5, window=case[6], attn_softcap=case[7])
    tnew = {n: _t(a) for n, a in new.items()}
    fused = ops.paged_gqa_decode_fused(_t(q), tc, tnew, _t(pos), **kw)
    kvcache.write_decode_paged(tc2, tnew, _t(pos))
    after = ops.paged_gqa_decode(_t(q), tc2, _t(pos), impl="ref", **kw)
    for g, w in zip(fused, after):
        assert torch.equal(g, w)
    for name in tc:
        assert torch.equal(tc[name], tc2[name])


def test_int8_arena_layout_matches_jax():
    cfg = _cfg(get_config, "qwen2.5-3b", kv_dtype="int8")
    tcfg = _cfg(t_get_config, "qwen2.5-3b", kv_dtype="int8")
    NB, bt = 6, 4
    want = jax_kvcache.init_paged_arena(cfg, NB, bt)
    got = kvcache.init_paged_arena(tcfg, NB, bt, device="cpu")
    P, Hkv = tcfg.num_periods, tcfg.num_kv_heads
    for key, g in got.items():
        assert sorted(g) == sorted(want[key]) == [
            "k", "k_scale", "slot_pos", "v", "v_scale"]
        assert tuple(g["k_scale"].shape) == (P, Hkv, NB + 1, bt)
        assert g["k"].dtype == torch.int8
        assert g["v_scale"].dtype == torch.float32
        for name, a in g.items():
            w = np.asarray(want[key][name])
            assert a.numpy().dtype == w.dtype and a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), w)
            for stacked in (False, True):
                assert kvcache.arena_block_axis(name, stacked=stacked) == \
                    jax_kvcache.arena_block_axis(name, stacked=stacked)
    x = np.random.default_rng(4).normal(size=(2, 6, 4, 3)).astype(np.float32)
    tiled = kvcache.retile_arena_leaf("k_scale", _t(x), stacked=True)
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(jax_kvcache.retile_arena_leaf(
            "k_scale", jnp.asarray(x), stacked=True)))
    ring = kvcache.init_cache(tcfg, 2, 16, device="cpu")["p0"]
    jring = jax_kvcache.init_cache(cfg, 2, 16)["p0"]
    for name, a in ring.items():
        assert tuple(a.shape) == jring[name].shape
        assert a.numpy().dtype == np.asarray(jring[name]).dtype


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def mixtral8():
    """mixtral smoke with int8 experts and int8 KV: both packages'
    configs and params (the port's through numpy, dtypes kept)."""
    cfg = _cfg(get_config, "mixtral-8x7b", expert_dtype="int8",
               kv_dtype="int8")
    tcfg = _cfg(t_get_config, "mixtral-8x7b", expert_dtype="int8",
                kv_dtype="int8")
    params = init_params(cfg, jax.random.key(0))
    npp = jax.tree.map(np.asarray, params)
    return cfg, tcfg, params, params_from_numpy(npp, device="cpu")


@pytest.fixture(scope="module")
def qwen8():
    cfg = _cfg(get_config, "qwen2.5-3b", kv_dtype="int8")
    tcfg = _cfg(t_get_config, "qwen2.5-3b", kv_dtype="int8")
    params = init_params(cfg, jax.random.key(1))
    return cfg, tcfg, params, params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")


def test_int8_expert_params_convert_unchanged(mixtral8):
    _, _, params, tparams = mixtral8
    jm = params["blocks"]["p0"]["moe"]
    tm = tparams["blocks"]["p0"]["moe"]
    assert tm["wi"].dtype == tm["wo"].dtype == torch.int8
    assert tm["wi_scale"].dtype == tm["wo_scale"].dtype == torch.float32
    for name in ("wi", "wo", "wi_scale", "wo_scale"):
        np.testing.assert_array_equal(tm[name].numpy(), np.asarray(jm[name]))


def test_init_params_draws_int8_experts_per_matrix(mixtral8):
    """The port's own int8 expert draw, one (layer, expert) matrix at a
    time: the JAX package's shapes and dtypes, N(0, 1) x 48 rounded and
    clipped to int8, and every matrix a draw of its own."""
    _, tcfg, params, _ = mixtral8
    got = t_params.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    jm, tm = params["blocks"]["p0"]["moe"], got["blocks"]["p0"]["moe"]
    for name in ("wi", "wo", "wi_scale", "wo_scale"):
        assert tuple(tm[name].shape) == jm[name].shape
        assert str(tm[name].dtype).split(".")[-1] == str(jm[name].dtype)
    for name in ("wi", "wo"):
        w = tm[name].float()
        assert float(w.abs().max()) <= 127
        assert abs(float(w.mean())) < 0.5 and abs(float(w.std()) - 48) < 2
        mats = w.flatten(0, 1)                # (layers x experts, ...)
        assert all(not torch.equal(mats[i], mats[j])
                   for i in range(len(mats)) for j in range(i))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_grouped_int8_matches_jax(mixtral8, use_kernel):
    cfg, tcfg, params, tparams = mixtral8
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["p0"]["moe"])
    tp = {k: v[0] for k, v in tparams["blocks"]["p0"]["moe"].items()}
    x = np.random.default_rng(3).normal(0, 1, (12, cfg.d_model)).astype(
        np.float32)
    want, want_aux = jax_moe.moe_grouped(cfg, jp, jnp.asarray(x))
    got, got_aux = moe.moe_grouped(tcfg, tp, _t(x), use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=TOL)


def _paged_cache(tcfg, cache, bt, seed):
    """`cache`'s rows moved into a paged arena (each row's blocks at
    scattered physical blocks, every block mapped), as the engine holds
    them: a cache whose period groups are arena + page table."""
    B, W = cache["pos"].shape[0], cache["p0"]["slot_pos"].shape[-1]
    MB = W // bt
    arena = kvcache.init_paged_arena(tcfg, B * MB + 1, bt, device="cpu")
    pt = torch.from_numpy(np.random.default_rng(seed).permutation(
        B * MB + 1)[:B * MB].reshape(B, MB).astype(np.int32))
    out = {"pos": cache["pos"].clone()}
    for key, group in cache.items():
        if key == "pos":
            continue
        out[key] = {**arena[key], "page_table": pt.expand(
            (tcfg.num_periods,) + tuple(pt.shape))} if key in arena \
            else {n: a.clone() for n, a in group.items()}
    for row in range(B):
        kvcache.insert_slot(out, cache, row, row)
    return out


def _decode_logits(cfg, tcfg, params, tparams, kinds, seed):
    """JAX logits of a prefill and three decode steps over the dense int8
    ring, and the port's for each of `kinds` ("dense", "paged")."""
    jpol = jax_model.ExecPolicy(moe_impl="grouped", use_kernels=False)
    tpol = model.ExecPolicy(moe_impl="grouped", use_kernels=True)
    rng = np.random.default_rng(seed)
    toks = [rng.integers(2, cfg.vocab_size, (2, 12)).astype(np.int32)] + [
        rng.integers(2, cfg.vocab_size, (2, 1)).astype(np.int32)
        for _ in range(3)]
    jcache = jax_kvcache.init_cache(cfg, 2, 32)
    want = []
    for i, tok in enumerate(toks):
        out = jax_model.forward(cfg, params, jnp.asarray(tok), cache=jcache,
                                mode="prefill" if i == 0 else "decode",
                                policy=jpol)
        jcache = out["cache"]
        want.append(np.asarray(jax_model.unembed(cfg, params,
                                                 out["hidden"])))
    for kind in kinds:
        tcache = kvcache.init_cache(tcfg, 2, 32, device="cpu")
        for i, tok in enumerate(toks):
            if i == 1 and kind == "paged":
                tcache = _paged_cache(tcfg, tcache, 8, seed)
            out = model.forward(tcfg, tparams, _t(tok), cache=tcache,
                                mode="prefill" if i == 0 else "decode",
                                policy=tpol)
            tcache = out["cache"]
            got = model.unembed(tcfg, tparams, out["hidden"]).numpy()
            np.testing.assert_allclose(got, want[i], rtol=TOL, atol=TOL,
                                       err_msg=f"{kind} step {i}")
        if kind == "dense":
            for name, a in tcache["p0"].items():
                assert a.dtype == (torch.int8 if name in ("k", "v") else
                                   torch.float32 if "scale" in name else
                                   torch.int32)


def test_qwen_int8_kv_logits_match_jax(qwen8):
    _decode_logits(*qwen8, ("dense", "paged"), 11)


def test_mixtral_int8_experts_and_kv_logits_match_jax(mixtral8):
    _decode_logits(*mixtral8, ("dense", "paged"), 12)


def test_qwen_int8_chunk_prefill_matches_jax(qwen8):
    """Chunked admission over an int8 ring: the chunk attends the quantized
    history with the scales folded in (no dequantized ring)."""
    from repro.serving import steps as jax_steps
    cfg, tcfg, params, tparams = qwen8
    n, width, max_seq = 21, 8, 64
    prompt = np.random.default_rng(n).integers(2, cfg.vocab_size, n) \
        .astype(np.int32)
    jstep = jax.jit(jax_steps.make_prefill_chunk(
        cfg, jax_model.ExecPolicy(moe_impl="dense")))
    tstep = steps.make_prefill_chunk(tcfg, model.ExecPolicy(moe_impl="dense"))
    jcache = jax_kvcache.init_cache(cfg, 1, max_seq)
    tcache = kvcache.init_cache(tcfg, 1, max_seq, device="cpu")
    t = 0
    while t < n:
        take = min(width, n - t)
        toks = np.zeros((1, width), np.int32)
        toks[0, :take] = prompt[t:t + take]
        fill = np.array([take], np.int32)
        want, jcache = jstep(params, jnp.asarray(toks), jcache,
                             jnp.asarray(fill))
        got, tcache = tstep(tparams, _t(toks), tcache, _t(fill))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        t += take
    assert tcache["p0"]["k"].dtype == torch.int8
    np.testing.assert_array_equal(tcache["p0"]["slot_pos"].numpy(),
                                  np.asarray(jcache["p0"]["slot_pos"]))


def test_int8_kv_decode_within_quant_budget(qwen8):
    """``test_serve_consistency.py``'s int8 budget: decode logits over the
    int8 ring track teacher forcing within a relative error of 0.05."""
    _, tcfg, _, tparams = qwen8
    B, S, nd = 2, 12, 3
    toks = _t(np.random.default_rng(7).integers(
        2, tcfg.vocab_size, (B, S + nd)).astype(np.int32))
    full = model.unembed(tcfg, tparams, model.forward(
        tcfg, tparams, toks, mode="train")["hidden"])
    cache = kvcache.init_cache(tcfg, B, S + nd + 1, device="cpu")
    model.forward(tcfg, tparams, toks[:, :S], cache=cache, mode="prefill")
    for t in range(nd):
        out = model.forward(tcfg, tparams, toks[:, S + t:S + t + 1],
                            cache=cache, mode="decode")
        lg = model.unembed(tcfg, tparams, out["hidden"][:, -1])
        rel = float((lg - full[:, S + t]).abs().max()
                    / full[:, S + t].abs().max())
        assert 0 < rel < 0.05, (t, rel)


def test_expert_paged_int8_forward_scales_survive(mixtral8):
    """``test_paging.py``'s int8 case: the f32 scales stay in the shared
    span (the expert pages are int8), and the expert-paged forward equals
    the resident one."""
    cfg, tcfg, params, tparams = mixtral8
    toks = np.random.default_rng(8).integers(
        2, cfg.vocab_size, (2, 8)).astype(np.int32)
    ref = model.unembed(tcfg, tparams, model.forward(
        tcfg, tparams, _t(toks))["hidden"])
    assert float(ref.abs().max()) > 0
    pw = paging.pack_block_groups_split(tparams["blocks"], 4096)
    em = pw.expert_manifests["p0"]
    assert {e.path[-1] for e in em.leaves} == {"wi", "wo"}
    assert pw.expert_pages["p0"].dtype == torch.int8
    assert {e.path[-1] for e in pw.manifests["p0"].leaves} >= {
        "wi_scale", "wo_scale"}
    got = model.unembed(tcfg, tparams, model.forward(
        tcfg, tparams, _t(toks), paged_blocks=pw)["hidden"])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        jpw = jax_paging.pack_block_groups_split(params["blocks"], 4096)
        want = jax_model.unembed(cfg, params, jax_model.forward(
            cfg, params, jnp.asarray(toks), paged_blocks=jpw)["hidden"])
    np.testing.assert_array_equal(pw.expert_pages["p0"].numpy(),
                                  np.asarray(jpw.expert_pages["p0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------------ engine

SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)
EXPERT = dict(expert_paged=True, page_elems=4096, w_gpu_ratio=0.25)
RUNS = {
    # qwen smoke, int8 KV (test_kv_paging.py's int8 workload)
    "kv8_dense": ("qwen", {}),
    "kv8_paged": ("qwen", dict(kv_paged=True, kv_gpu_ratio=0.25)),
    # mixtral smoke, int8 experts and int8 KV
    "w8_resident": ("mixtral", {}),
    "w8_expert": ("mixtral", EXPERT),
    "w8_expert_windows": ("mixtral", dict(EXPERT, module_batch=True)),
    "w8_both": ("mixtral", dict(EXPERT, kv_paged=True, kv_gpu_ratio=0.25)),
}


def _work(vocab, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, int(rng.integers(2, 24))),
             int(rng.integers(1, 8))) for _ in range(5)]


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(out={r: eng.scheduler.requests[r].generated for r in rids},
                preemptions=[eng.scheduler.requests[r].preemptions
                             for r in rids],
                histories=[s.history for s in slots],
                kv=eng.kv_traffic(), weight=eng.weight_traffic(),
                tokens_out=eng.tokens_out)


@pytest.fixture(scope="module")
def jax_runs(qwen8, mixtral8):
    models = {"qwen": qwen8, "mixtral": mixtral8}
    works = {"qwen": _work(qwen8[0].vocab_size, 5),
             "mixtral": _work(mixtral8[0].vocab_size, 6)}
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, (arch, kw) in RUNS.items():
            cfg, _, params, _ = models[arch]
            eng = JaxEngine(cfg, params, JaxEngineConfig(
                **SLOTS, **kw, watchdog=False, degrade=False),
                jax_model.ExecPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in works[arch]]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return dict(models=models, works=works, runs=runs)


@pytest.mark.parametrize("run", list(RUNS))
def test_int8_engine_matches_jax(jax_runs, run):
    arch, kw = RUNS[run]
    _, tcfg, _, tparams = jax_runs["models"][arch]
    eng = Engine(tcfg, tparams, EngineConfig(**SLOTS, **kw),
                 model.ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device="cpu")
    work = jax_runs["works"][arch]
    rids = [eng.submit(p, q) for p, q in work]
    eng.run_until_idle()
    got, want = _record(eng, rids), jax_runs["runs"][run]
    assert got == want
    assert all(len(got["out"][r]) == q for r, (_, q) in zip(rids, work))
    assert all(s.state is SlotState.FREE
               for grp in eng.scheduler.slots for s in grp)
    kv, w = got["kv"], got["weight"]
    if kw.get("kv_paged"):
        # the mixtral workload overflows the arena: the int8 rows and
        # their scales spill to the host tier and come back
        assert (kv["spills"] > 0 and kv["misses"] > 0) == (arch == "mixtral")
        eng._kv.check_invariants()
        arena = eng._kv_arena["p0"]
        assert arena["k"].dtype == torch.int8
        assert eng._kv_host["p0"]["k_scale"].dtype == torch.float32
    if kw.get("expert_paged"):
        assert w["misses"] > 0 and w["h2d_bytes"] > 0
        assert eng.paged_blocks.expert_pages["p0"].dtype == torch.int8


def test_int8_paged_transcripts_equal_dense(jax_runs):
    """``test_kv_paging.py``: the int8 arena's greedy transcripts equal the
    dense int8 ring's."""
    runs = jax_runs["runs"]
    assert runs["kv8_paged"]["out"] == runs["kv8_dense"]["out"]
