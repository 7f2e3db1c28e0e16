"""Overlapped chunked-prefill admission in the port against the JAX
package's.

  * Chunk mode: a prompt drained through ``steps.make_prefill_chunk`` in
    fixed-width chunks on a batch-1 scratch gives each chunk's logits
    within 1e-4 of the reference's (float32, the dense MoE), for the
    mixtral smoke (GQA) and the DeepSeek-V3 smoke (MLA, with its dense
    prologue); the last chunk's logits are within 1e-4 of the port's
    monolithic prefill, and the scratch ring holds the reference's
    values.
  * ``kvcache.insert_slot_span`` equal to the reference's, on a dense pool
    (spans that wrap the ring included) and through a page table into the
    paged arena (every block but the trash block, which nothing reads).
  * Engine: mixtral smoke in float32; with ``overlap`` the greedy
    transcripts, slot histories and the ``weight_traffic()`` and
    ``kv_traffic()`` dicts equal the JAX engine's in the same mode at
    ``prefill_chunk`` 4, 8 and 16, over the paged arena at r_c 0.25,
    expert-paged at r_w 0.25, and with module batching.  Each port run is
    pinned to the JAX run of its own mode: some of the reference's sweeps
    that pin every mode to one transcript fail in its own runs.

The JAX engines run with their watchdog and degradation ladder off, with
``offload.pinned_host_sharding`` patched to None (as in
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
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving import steps as jax_steps  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving import steps  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

TOL = 1e-4     # f32 logits through several layers, summed in another order


def _smoke(get, arch="mixtral-8x7b"):
    return dataclasses.replace(get(arch).smoke(), dtype="float32")


def _tree_np(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_np(tree[k], prefix + (k,))
        else:
            v = tree[k]
            yield prefix + (k,), (v.numpy() if isinstance(v, torch.Tensor)
                                  else np.asarray(v))


# --------------------------------------------------------------- chunk mode

@pytest.mark.parametrize("arch,width,n", [("mixtral-8x7b", 8, 21),
                                          ("mixtral-8x7b", 16, 40),
                                          ("deepseek-v3-671b", 8, 19)])
def test_chunk_prefill_matches_jax(arch, width, n):
    cfg, tcfg = _smoke(get_config, arch), _smoke(t_get_config, arch)
    params = init_params(cfg, jax.random.key(4))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    prompt = np.random.default_rng(n).integers(2, cfg.vocab_size, n) \
        .astype(np.int32)
    max_seq = 64
    # the dense MoE drops no token: the grouped one's capacity depends on
    # how many tokens share a call, so a chunk may drop other tokens than
    # the whole prompt does (the engine tests run it)
    jstep = jax.jit(jax_steps.make_prefill_chunk(
        cfg, JaxPolicy(moe_impl="dense")))
    tpol = ExecPolicy(moe_impl="dense")
    tstep = steps.make_prefill_chunk(tcfg, tpol)
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
        got, tcache = tstep(tparams, torch.from_numpy(toks), tcache,
                            torch.from_numpy(fill))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
        t += take
    assert int(tcache["pos"][0]) == n
    got_leaves = dict(_tree_np(tcache))
    for path, want_leaf in _tree_np(jcache):
        if path[-1] == "slot_pos" or path == ("pos",):
            np.testing.assert_array_equal(got_leaves[path], want_leaf)
        else:
            np.testing.assert_allclose(got_leaves[path], want_leaf,
                                       rtol=TOL, atol=TOL)
    # the last chunk's logits are the monolithic prefill's
    mono, _ = steps.make_prefill_fill_step(tcfg, tpol)(
        tparams, torch.from_numpy(prompt[None]),
        kvcache.init_cache(tcfg, 1, max_seq, device="cpu"),
        torch.tensor([n], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), mono.numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------- insert_slot_span

def _random_cache(cfg, batch, max_seq, seed):
    rng = np.random.default_rng(seed)
    cache = jax.tree.map(np.array, jax_kvcache.init_cache(cfg, batch,
                                                          max_seq))
    for path, leaf in _tree_np(cache):
        node = cache
        for k in path[:-1]:
            node = node[k]
        if leaf.dtype.kind == "f":
            node[path[-1]] = rng.normal(size=leaf.shape).astype(leaf.dtype)
        else:
            node[path[-1]] = rng.integers(-1, 50, leaf.shape) \
                .astype(leaf.dtype)
    return cache


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


@pytest.mark.parametrize("start,length", [(0, 8), (5, 16), (20, 16),
                                          (27, 8)])
def test_insert_slot_span_dense_matches_jax(start, length):
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    jpool, tpool = _both(_random_cache(cfg, 3, 32, 1))
    jsingle, tsingle = _both(_random_cache(cfg, 1, 32, 2))
    want = jax_kvcache.insert_slot_span(jpool, jsingle, 1, start,
                                        length=length)
    got = kvcache.insert_slot_span(tpool, tsingle, 1, start, length=length)
    got_leaves = dict(_tree_np(got))
    for path, leaf in _tree_np(want):
        np.testing.assert_array_equal(got_leaves[path], leaf)


@pytest.mark.parametrize("start,length", [(0, 8), (3, 16), (12, 4),
                                          (20, 16), (30, 8)])
def test_insert_slot_span_paged_matches_jax(start, length):
    """A slot of 4 blocks of 8 (blocks 0, 1 and 3 mapped, 2 unmapped) in
    an arena of 9 blocks and the trash block."""
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    rng = np.random.default_rng(start + length)
    arena = jax.tree.map(np.array, jax_kvcache.init_paged_arena(cfg, 9, 8))
    for g in arena.values():
        for name, a in g.items():
            g[name] = (rng.normal(size=a.shape).astype(a.dtype)
                       if a.dtype.kind == "f"
                       else rng.integers(-1, 40, a.shape).astype(a.dtype))
    pt = np.full((2, 4), -1, np.int32)
    pt[0] = [0, 1, 2, 3]
    pt[1] = [7, 4, -1, 5]
    pos = np.zeros((2,), np.int32)
    single = _random_cache(cfg, 1, 32, 3)

    def compose(arena, pt, pos):
        out = {"pos": pos}
        for key, g in arena.items():
            out[key] = {**g, "page_table": pt}
        return out

    jarena, tarena = _both(arena)
    jc = compose(jarena, jnp.asarray(np.broadcast_to(
        pt, (cfg.num_periods,) + pt.shape)), jnp.asarray(pos))
    tc = compose(tarena, torch.from_numpy(pt).expand(
        (tcfg.num_periods,) + pt.shape), torch.from_numpy(pos))
    jsingle, tsingle = _both(single)
    want = jax_kvcache.insert_slot_span(jc, jsingle, 1, start, length=length)
    kvcache.insert_slot_span(tc, tsingle, 1, start, length=length)
    assert int(tc["pos"][1]) == int(want["pos"][1])
    for key in tarena:
        for name, a in tarena[key].items():
            ax = kvcache.arena_block_axis(name, stacked=True)
            keep = [slice(None)] * a.ndim
            keep[ax] = slice(0, 9)                     # all but the trash
            np.testing.assert_array_equal(
                a.numpy()[tuple(keep)],
                np.asarray(want[key][name])[tuple(keep)])


# ------------------------------------------------------------------ engine

LENS = (5, 14, 3, 40, 9, 20, 11)
QUOTAS = (6, 3, 9, 9, 5, 7, 8)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4, overlap=True)
RUNS = {
    "p4": dict(prefill_chunk=4),
    "p8": dict(prefill_chunk=8),
    "p16": dict(prefill_chunk=16),
    "kv_rc025": dict(prefill_chunk=8, kv_paged=True, kv_gpu_ratio=0.25),
    "expert_rw025": dict(prefill_chunk=8, expert_paged=True,
                         page_elems=4096, w_gpu_ratio=0.25),
    "module": dict(prefill_chunk=8, module_batch=True),
}


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(out={r: eng.scheduler.requests[r].generated for r in rids},
                histories=[s.history for s in slots],
                weight=eng.weight_traffic(), kv=eng.kv_traffic(),
                tokens_out=eng.tokens_out, steps=eng.steps)


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
def test_overlap_engine_matches_jax(jax_runs, run):
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(jax_runs["params"], device="cpu"),
                 EngineConfig(**SLOTS, **RUNS[run]),
                 ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(jax_runs["prompts"], QUOTAS)]
    eng.run_until_idle()
    got = _record(eng, rids)
    assert got == jax_runs["runs"][run]
    assert all(len(got["out"][r]) == q for r, q in zip(rids, QUOTAS))
    # every staged admission drained, both scratches back in the pool
    assert not eng._staged and eng._stage_scratch is None
    assert len(eng._free_scratches) == 2
    if run == "kv_rc025":
        assert got["kv"]["spills"] > 0 and got["kv"]["misses"] > 0
        eng._kv.check_invariants()
    if run == "expert_rw025":
        assert got["weight"]["misses"] > 0
    if run == "module":
        assert got["weight"]["module_batch"]
