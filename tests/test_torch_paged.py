"""The port's block-paged KV serving path against the JAX package's.

  * Arena and kernel: the arena's layout helpers, the decode scatter, the
    gathered view and the paged decode's plain version (the path a CPU
    tensor takes through the kernel's wrapper) against the JAX functions
    and its Pallas kernel in interpret mode, in float32; the fused
    decode-write form against write-then-attend, bit for bit.
  * BlockPool: one seeded trace of operations through both control planes
    gives the same plans, counters and page tables.
  * Engine: mixtral smoke in float32, 2 groups x 2 slots, a workload that
    spills, fetches, prefetches and preempts at r_c 0.25; transcripts,
    slot histories and every ``kv_traffic()`` counter equal the JAX
    engine's at r_c 1.0 and 0.25, and at 0.25 without prefetch.

The JAX engines run with their watchdog and degradation ladder off and are
built once per module.  Their host tier is forced onto its pageable numpy
fallback (``engine.py`` takes it when ``offload.pinned_host_sharding``
returns None), because placing arrays in JAX's ``pinned_host`` memory fails
on some CPU backends; the port's own tier is a plain CPU tensor here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import blockpool as jax_blockpool  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import blockpool  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import SlotState  # noqa: E402
from test_torch_kernels import (PAGED_CASES, paged_inputs,  # noqa: E402
                                unmap_fresh_block)

TOL = 1e-5     # f32 partials: both sides sum in f32, in another order


def _smoke(get):
    return dataclasses.replace(get("mixtral-8x7b").smoke(), dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ arena, kernel

def test_paged_arena_layout_matches_jax():
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    want = jax_kvcache.init_paged_arena(cfg, 5, 8)
    got = kvcache.init_paged_arena(tcfg, 5, 8, device="cpu")
    assert kvcache.paged_period_keys(tcfg) == \
        jax_kvcache.paged_period_keys(cfg) == tuple(got)
    for key, g in got.items():
        assert sorted(g) == sorted(want[key])
        for name, a in g.items():
            w = want[key][name]
            assert tuple(a.shape) == w.shape and a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            for stacked in (False, True):
                assert kvcache.arena_block_axis(name, stacked=stacked) == \
                    jax_kvcache.arena_block_axis(name, stacked=stacked)
    rng = np.random.default_rng(0)
    for name, shape in (("k", (2, 6, 4, 3, 5)), ("slot_pos", (2, 6, 4))):
        x = rng.normal(size=shape).astype(np.float32)
        tiled = kvcache.retile_arena_leaf(name, _t(x), stacked=True)
        np.testing.assert_array_equal(
            tiled.numpy(), np.asarray(jax_kvcache.retile_arena_leaf(
                name, jnp.asarray(x), stacked=True)))
        back = kvcache.untile_arena_leaf(name, tiled, stacked=True)
        np.testing.assert_array_equal(back.numpy(), x)


def _caches(case, seed, fresh_unmapped=False):
    """The same paged layer cache for both packages, and the decode inputs
    (trash block zero: the plain versions read it for unmapped blocks);
    with `fresh_unmapped`, row 1's fresh token falls in an unmapped
    block."""
    inputs = paged_inputs(case, seed)
    if fresh_unmapped:
        inputs = unmap_fresh_block(inputs, 1)
    q, k, v, sp, pt, pos, kn, vn = inputs
    jc = dict(k=jnp.asarray(k), v=jnp.asarray(v), slot_pos=jnp.asarray(sp),
              page_table=jnp.asarray(pt))
    tc = dict(k=_t(k), v=_t(v), slot_pos=_t(sp), page_table=_t(pt))
    return q, pos, kn, vn, jc, tc


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_view_and_scatter_match_jax(case):
    q, pos, kn, vn, jc, tc = _caches(case, 1)
    want = jax_kvcache.paged_view(jc)
    for name, a in kvcache.paged_view(tc).items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(want[name]))
    new = {"k": kn[:, None], "v": vn[:, None]}
    want = jax_kvcache._decode_scatter(
        jc, {n: jnp.asarray(a) for n, a in new.items()}, jnp.asarray(pos))
    got = kvcache.write_decode_paged(
        tc, {n: _t(a) for n, a in new.items()}, _t(pos))
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


# the first two cases, a group of 16 heads and blocks that straddle tiles
@pytest.mark.parametrize("case", PAGED_CASES[:2] + [PAGED_CASES[4],
                                                   PAGED_CASES[7]])
def test_paged_gqa_decode_plain_matches_pallas(case):
    """Unfused and fused, against the Pallas kernel in interpret mode;
    the fused form's arena scatter equals the JAX one exactly."""
    _plain_matches_pallas(case, 2)


@pytest.mark.parametrize("case", [PAGED_CASES[0], PAGED_CASES[7]])
def test_paged_fresh_block_unmapped_matches_pallas(case):
    """As above with row 1's fresh token in an unmapped block: attention
    masks it and the scatter sends it to the trash block, in both."""
    _plain_matches_pallas(case, 4, fresh_unmapped=True)


def _plain_matches_pallas(case, seed, fresh_unmapped=False):
    q, pos, kn, vn, jc, tc = _caches(case, seed, fresh_unmapped)
    kw = dict(scale=case[3] ** -0.5, window=case[6], attn_softcap=case[7])
    jq, jpos = jnp.asarray(q), jnp.asarray(pos)
    want = jax_ops.paged_gqa_decode(jq, jc, jpos, impl="interpret", **kw)
    unfused = ops.paged_gqa_decode(_t(q), tc, _t(pos), **kw)
    for g, w in zip(unfused, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)
    new = {"k": kn[:, None], "v": vn[:, None]}
    want, jcache = jax_ops.paged_gqa_decode_fused(
        jq, jc, {n: jnp.asarray(a) for n, a in new.items()}, jpos,
        impl="interpret", **kw)
    got = ops.paged_gqa_decode_fused(
        _t(q), tc, {n: _t(a) for n, a in new.items()}, _t(pos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jcache[name]))
    if fresh_unmapped:                  # the masked token changes nothing
        for g, u in zip(got, unfused):
            assert torch.equal(g[1], u[1])


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_fused_equals_write_then_attend(case):
    """The fused form (the kernel wrapper's path: the fresh token merged
    into the gathered view, the arena scattered after) against the
    scatter followed by the unfused plain version, bit for bit."""
    q, pos, kn, vn, _, tc = _caches(case, 3)
    _, _, _, _, _, tc2 = _caches(case, 3)
    kw = dict(scale=case[3] ** -0.5, window=case[6], attn_softcap=case[7])
    new = {"k": _t(kn[:, None]), "v": _t(vn[:, None])}
    fused = ops.paged_gqa_decode_fused(_t(q), tc, new, _t(pos), **kw)
    kvcache.write_decode_paged(tc2, new, _t(pos))
    after = ops.paged_gqa_decode(_t(q), tc2, _t(pos), impl="ref", **kw)
    for g, w in zip(fused, after):
        assert torch.equal(g, w)
    for name in tc:
        assert torch.equal(tc[name], tc2[name])
    if case[0] > 2:                          # row 0 maps no block at all
        assert not fused[0][0].any() and not fused[1][0].any() \
            and not fused[2][0].any()


# --------------------------------------------------------------- BlockPool

def test_blockpool_trace_matches_jax():
    n_slots, mb, dev_blocks, bt = 4, 6, 9, 4
    pools = (blockpool.BlockPool(n_slots, mb, dev_blocks, 100),
             jax_blockpool.BlockPool(n_slots, mb, dev_blocks, 100))
    rng = np.random.default_rng(7)
    for step in range(300):
        op = rng.choice(["tokens", "range", "prefetch", "free"],
                        p=[0.4, 0.2, 0.25, 0.15])
        slot = int(rng.integers(n_slots))
        n_tok = int(rng.integers(1, mb * bt + 4))
        protect = [int(s) for s in rng.choice(n_slots, rng.integers(0, 3),
                                              replace=False)]
        out = []
        for pool in pools:
            if op == "tokens":
                out.append(pool.ensure_tokens(slot, n_tok, bt, protect))
            elif op == "range":
                lo = pool.n_mapped(slot) // 2
                out.append(pool.ensure_range(slot, lo, lo + 2, protect))
            elif op == "prefetch":
                host = pool.host_resident_blocks(slot)
                out.append(pool.prefetch(slot, host[0]) if host else None)
            else:
                out.append(pool.free_slot(slot))
            pool.check_invariants()
        assert out[0] == out[1], (step, op)
        for a, b in zip(*(dataclasses.astuple(p.counters) for p in pools)):
            assert a == b
        rows = list(range(n_slots))
        np.testing.assert_array_equal(pools[0].device_table(rows),
                                      pools[1].device_table(rows))
        np.testing.assert_array_equal(pools[0].host, pools[1].host)
        assert pools[0].peak_in_use == pools[1].peak_in_use
    c = pools[0].counters
    assert c.spills and c.misses and c.prefetches and c.frees


# ------------------------------------------------------------------ engine

LENS = (5, 14, 3, 40, 9, 20)
QUOTAS = (6, 3, 9, 9, 5, 7)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4, kv_paged=True)
RUNS = {"rc1": dict(kv_gpu_ratio=1.0),
        "rc025": dict(kv_gpu_ratio=0.25),
        "rc025_noprefetch": dict(kv_gpu_ratio=0.25, kv_prefetch=False)}


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
    params = init_params(cfg, jax.random.key(1))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in LENS]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, kw in RUNS.items():
            eng = JaxEngine(cfg, params, JaxEngineConfig(
                **SLOTS, **kw, watchdog=False, degrade=False),
                JaxPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return dict(params=jax.tree.map(np.asarray, params), prompts=prompts,
                runs=runs)


@pytest.mark.parametrize("run", list(RUNS))
def test_paged_engine_matches_jax(jax_runs, run):
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(jax_runs["params"], device="cpu"),
                 EngineConfig(**SLOTS, **RUNS[run]),
                 ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(jax_runs["prompts"], QUOTAS)]
    eng.run_until_idle()
    got, want = _record(eng, rids), jax_runs["runs"][run]
    assert got == want
    assert all(got["free"])
    assert all(s.state is SlotState.FREE
               for grp in eng.scheduler.slots for s in grp)
    assert all(len(got["out"][r]) == q for r, q in zip(rids, QUOTAS))
    tr = got["traffic"]
    if run == "rc1":
        assert tr["spills"] == tr["misses"] == 0
    else:                # the arena overflows: the host tier is exercised
        assert tr["spills"] > 0 and tr["misses"] > 0
        assert sum(got["preemptions"]) > 0
        assert (tr["prefetches"] > 0) == (run == "rc025")
    eng._kv.check_invariants()
