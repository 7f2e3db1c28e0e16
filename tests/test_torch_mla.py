"""The port's DeepSeek-V3 MLA serving path against the JAX package's.

  * Latent arena and kernel: the MLA arena's layout, its decode scatter and
    gathered view, and the absorbed-MLA paged decode's plain version (the
    path a CPU tensor takes through the kernel's wrapper) against the JAX
    functions, its Pallas kernel in interpret mode and its oracle, in
    float32; the fused decode-write form against write-then-attend, bit for
    bit.
  * Model: one MLA layer in full and decode mode (the absorbed decode also
    against the naive form), the DeepSeek smoke's logits (prologue
    included), and ``count_params``.
  * Engine: the DeepSeek smoke in float32, 2 groups x 2 slots over the
    paged latent arena (the prologue's rings stay dense); transcripts, slot
    histories and every ``kv_traffic()`` counter equal the JAX engine's at
    r_c 1.0 and 0.25.

The JAX engines run with their watchdog and degradation ladder off and are
built once per module; their host tier is forced onto its pageable numpy
fallback, as in ``test_torch_paged.py``.
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
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import kvcache, model, params  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import SlotState  # noqa: E402
from test_torch_kernels import MLA_CASES, mla_inputs  # noqa: E402

TOL_PARTIALS = 1e-5   # f32 partials: both sides sum in f32, in other orders
TOL = 1e-4            # f32 end to end
ARCH = "deepseek-v3-671b"


def _smoke(get):
    return dataclasses.replace(get(ARCH).smoke(), dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ arena, kernel

def test_mla_arena_and_cache_layout_match_jax():
    """The latent arena (no head axis: ckv (L, NB+1, bt, lat)) and the
    dense cache with its prologue rings, leaf by leaf."""
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    assert kvcache.paged_period_keys(tcfg) == \
        jax_kvcache.paged_period_keys(cfg) == ("p0",)
    want = jax_kvcache.init_paged_arena(cfg, 5, 8)
    got = kvcache.init_paged_arena(tcfg, 5, 8, device="cpu")
    assert tuple(got) == tuple(want)
    for key, g in got.items():
        assert sorted(g) == sorted(want[key]) == ["ckv", "kr", "slot_pos"]
        for name, a in g.items():
            assert tuple(a.shape) == want[key][name].shape
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(want[key][name]))
            for stacked in (False, True):
                assert kvcache.arena_block_axis(name, stacked=stacked) == \
                    jax_kvcache.arena_block_axis(name, stacked=stacked)
    want = jax_kvcache.init_cache(cfg, 2, 16, skip_keys=("p0",))
    got = kvcache.init_cache(tcfg, 2, 16, skip_keys=("p0",), device="cpu")
    assert sorted(got) == sorted(want) == ["pos", "prologue"]
    for name, a in got["prologue"].items():
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(want["prologue"][name]))


def _caches(case, seed):
    """The same paged latent layer cache for both packages, and the decode
    inputs (trash block zero: the plain versions read it for unmapped
    blocks)."""
    q, ckv, kr, sp, pt, pos, cn, rn = mla_inputs(case, seed)
    jc = dict(ckv=jnp.asarray(ckv), kr=jnp.asarray(kr),
              slot_pos=jnp.asarray(sp), page_table=jnp.asarray(pt))
    tc = dict(ckv=_t(ckv), kr=_t(kr), slot_pos=_t(sp), page_table=_t(pt))
    return q, pos, {"ckv": cn[:, None], "kr": rn[:, None]}, jc, tc


@pytest.mark.parametrize("case", MLA_CASES)
def test_mla_paged_view_and_scatter_match_jax(case):
    q, pos, new, jc, tc = _caches(case, 1)
    want = jax_kvcache.paged_view(jc)
    for name, a in kvcache.paged_view(tc).items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(want[name]))
    want = jax_kvcache._decode_scatter(
        jc, {n: jnp.asarray(a) for n, a in new.items()}, jnp.asarray(pos))
    got = kvcache.write_decode_paged(
        tc, {n: _t(a) for n, a in new.items()}, _t(pos))
    for name in ("ckv", "kr", "slot_pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("case", MLA_CASES[:2])
def test_paged_mla_decode_plain_matches_pallas(case):
    """Unfused and fused, against the Pallas kernel in interpret mode and
    the JAX oracle; the fused form's arena scatter equals the JAX one."""
    q, pos, new, jc, tc = _caches(case, 2)
    lat = case[2]
    kw = dict(scale=(lat + case[3]) ** -0.5)
    jq, jpos = jnp.asarray(q), jnp.asarray(pos)
    interp = jax_ops.paged_mla_decode(jq, jc, jpos, lat=lat,
                                      impl="interpret", **kw)
    oracle = jax_ref.paged_mla_decode_ref(jq, jc, jpos, **kw)
    got = ops.paged_mla_decode(_t(q), tc, _t(pos), **kw)
    for g, w, o in zip(got, interp, oracle):
        _close(g.numpy(), w, TOL_PARTIALS)
        _close(g.numpy(), o, TOL_PARTIALS)
    want, jcache = jax_ops.paged_mla_decode_fused(
        jq, jc, {n: jnp.asarray(a) for n, a in new.items()}, jpos, lat=lat,
        impl="interpret", **kw)
    got = ops.paged_mla_decode_fused(
        _t(q), tc, {n: _t(a) for n, a in new.items()}, _t(pos), **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), w, TOL_PARTIALS)
    for name in ("ckv", "kr", "slot_pos"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jcache[name]))


@pytest.mark.parametrize("case", MLA_CASES)
def test_paged_mla_fused_equals_write_then_attend(case):
    """The fused form (the fresh latent merged into the gathered view, the
    arena scattered after) against the scatter followed by the unfused
    plain version, bit for bit."""
    q, pos, new, _, tc = _caches(case, 3)
    _, _, _, _, tc2 = _caches(case, 3)
    kw = dict(scale=(case[2] + case[3]) ** -0.5)
    new = {n: _t(a) for n, a in new.items()}
    fused = ops.paged_mla_decode_fused(_t(q), tc, new, _t(pos), **kw)
    kvcache.write_decode_paged(tc2, new, _t(pos))
    after = ops.paged_mla_decode(_t(q), tc2, _t(pos), impl="ref", **kw)
    for g, w in zip(fused, after):
        assert torch.equal(g, w)
    for name in tc:
        assert torch.equal(tc[name], tc2[name])
    if case[0] > 2:                          # row 0 maps no block at all
        assert not any(t[0].any() for t in fused)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def smoke():
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    jp = jax_params.init_params(cfg, jax.random.key(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tcfg, jp, tp


def test_count_params_matches_jax():
    for arch in (get_config(ARCH), dataclasses.replace(get_config(ARCH),
                                                       num_layers=5)):
        tarch = dataclasses.replace(t_get_config(ARCH),
                                    num_layers=arch.num_layers)
        for cfg, tcfg in ((arch, tarch), (arch.smoke(), tarch.smoke())):
            for active in (False, True):
                assert params.count_params(tcfg, active_only=active) == \
                    jax_params.count_params(cfg, active_only=active)


def test_mla_forward_matches_jax(smoke):
    """One MLA layer (the first prologue layer): full mode, then prefill
    into a dense latent ring and two absorbed decode steps over it; each
    decode output also equals the naive form's last position over the
    whole sequence."""
    cfg, tcfg, jp, tp = smoke
    spec = cfg.prologue[0]
    jattn = jax.tree.map(lambda a: a[0], jp["prologue"]["p0"]["attn"])
    tattn = {k: v[0] for k, v in tp["prologue"]["p0"]["attn"].items()}
    B, S, W = 2, 6, 16
    x = np.random.default_rng(4).normal(
        0, 1, (B, S + 2, cfg.d_model)).astype(np.float32)
    pos_all = np.broadcast_to(np.arange(S + 2), (B, S + 2)).astype(np.int32)

    def jfull(n, cache=None):
        return jax_attention.mla_forward(
            cfg, spec, jattn, jnp.asarray(x[:, :n]),
            jnp.asarray(pos_all[:, :n]), cache=cache, mode="full")

    def tfull(n, cache=None):
        return attention.mla_forward(
            tcfg, spec, tattn, _t(x[:, :n]), _t(pos_all[:, :n]),
            cache=cache, mode="full")

    _close(tfull(S)[0].numpy(), jfull(S)[0], TOL)
    jcache = jax.tree.map(lambda a: a[0], jax_kvcache.init_cache(
        cfg, B, W)["prologue"])
    tcache = {k: v[0] for k, v in kvcache.init_cache(
        tcfg, B, W, device="cpu")["prologue"].items()}
    _, jcache = jfull(S, jcache)
    tfull(S, tcache)
    for name, a in tcache.items():
        _close(a.numpy(), jcache[name], TOL)
    for n in (S, S + 1):
        pos = np.full((B,), n, np.int32)
        want, jcache = jax_attention.mla_forward(
            cfg, spec, jattn, jnp.asarray(x[:, n:n + 1]),
            jnp.asarray(pos[:, None]), cache=jcache, mode="decode",
            pos=jnp.asarray(pos))
        got, _ = attention.mla_forward(
            tcfg, spec, tattn, _t(x[:, n:n + 1]), _t(pos[:, None]),
            cache=tcache, mode="decode", pos=_t(pos))
        _close(got.numpy(), want, TOL)
        _close(got.numpy()[:, 0], tfull(n + 1)[0].numpy()[:, n], TOL)


def test_deepseek_logits_match_jax(smoke):
    """A train forward, a prefill into the dense cache (prologue rings
    included) and three decode steps: logits within 1e-4."""
    cfg, tcfg, jp, tp = smoke
    jpol = jax_model.ExecPolicy(moe_impl="grouped", use_kernels=False)
    tpol = model.ExecPolicy(moe_impl="grouped", use_kernels=True)
    rng = np.random.default_rng(11)
    prompt = rng.integers(2, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = jax_model.forward(cfg, jp, jnp.asarray(prompt), policy=jpol)
    got = model.forward(tcfg, tp, _t(prompt), policy=tpol)
    _close(model.unembed(tcfg, tp, got["hidden"]).numpy(),
           jax_model.unembed(cfg, jp, want["hidden"]), TOL)
    jcache = jax_kvcache.init_cache(cfg, 2, 32)
    tcache = kvcache.init_cache(tcfg, 2, 32, device="cpu")
    toks = [prompt] + [rng.integers(2, cfg.vocab_size, (2, 1)).astype(
        np.int32) for _ in range(3)]
    for i, tok in enumerate(toks):
        mode = "prefill" if i == 0 else "decode"
        want = jax_model.forward(cfg, jp, jnp.asarray(tok), cache=jcache,
                                 mode=mode, policy=jpol)
        jcache = want["cache"]
        got = model.forward(tcfg, tp, _t(tok), cache=tcache, mode=mode,
                            policy=tpol)
        _close(model.unembed(tcfg, tp, got["hidden"]).numpy(),
               jax_model.unembed(cfg, jp, want["hidden"]), TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


# ------------------------------------------------------------------ engine

LENS = (5, 14, 3, 40, 9, 20)
QUOTAS = (6, 3, 9, 9, 5, 7)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4, kv_paged=True)
RUNS = {"rc1": dict(kv_gpu_ratio=1.0), "rc025": dict(kv_gpu_ratio=0.25)}


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(
        out={r: eng.scheduler.requests[r].generated for r in rids},
        histories=[s.history for s in slots],
        free=[s.state.value == "free" for s in slots],
        preemptions=[eng.scheduler.requests[r].preemptions for r in rids],
        traffic=eng.kv_traffic(), tokens_out=eng.tokens_out)


@pytest.fixture(scope="module")
def jax_runs():
    cfg = _smoke(get_config)
    jp = jax_params.init_params(cfg, jax.random.key(1))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in LENS]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, kw in RUNS.items():
            eng = JaxEngine(cfg, jp, JaxEngineConfig(
                **SLOTS, **kw, watchdog=False, degrade=False),
                jax_model.ExecPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return dict(params=jax.tree.map(np.asarray, jp), prompts=prompts,
                runs=runs)


@pytest.mark.parametrize("run", list(RUNS))
def test_mla_engine_matches_jax(jax_runs, run):
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(jax_runs["params"], device="cpu"),
                 EngineConfig(**SLOTS, **RUNS[run]),
                 model.ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(jax_runs["prompts"], QUOTAS)]
    eng.run_until_idle()
    got, want = _record(eng, rids), jax_runs["runs"][run]
    assert got == want
    assert "prologue" in eng.groups[0].cache          # dense beside the arena
    assert all(s.state is SlotState.FREE
               for grp in eng.scheduler.slots for s in grp)
    assert all(len(got["out"][r]) == q for r, q in zip(rids, QUOTAS))
    tr = got["traffic"]
    if run == "rc1":
        assert tr["spills"] == tr["misses"] == 0
    else:                # the arena overflows: the host tier is exercised
        assert tr["spills"] > 0 and tr["misses"] > 0 and tr["prefetches"] > 0
        assert sum(got["preemptions"]) > 0
    eng._kv.check_invariants()
