"""The port's expert-granular paged weights against the JAX package's.

  * Packing: the split pools (shared pages and per-(layer, expert) spans)
    and their manifests equal ``repro.core.paging``'s bit for bit, and the
    layer-by-layer writer equals the stacked packers.
  * Routing compaction: ``activated_experts`` gives the reference's
    ``sel``, ``index_map`` and ``n_act``, also where T·K < E.
  * The gather: the expert gather's plain version (the path a CPU tensor
    takes through the kernel's wrapper) equals ``_ExpertCtx.make_fetch`` on
    the real slots and zeroes the pad slots.
  * ``moe_paged`` within 1e-5 of the reference in float32, dense and
    grouped, its counts exactly equal.
  * Control plane: ``ExpertResidency`` and ``GatePredictor`` driven by one
    seeded trace keep the same state in both packages.
  * Engine: mixtral smoke in float32; greedy transcripts and the whole
    ``weight_traffic()`` dict equal the JAX engine's in every regime, and
    the expert-paged transcripts equal the port's resident engine's.

On the card (marker ``cuda``, skipped elsewhere) the gather equals its
plain version bit for bit at mixtral's served span, at odd shapes and with
no, every and some slots missed; 56 gathers back to back keep each layer's
outputs; host calls that block inside CUDA right after a gather do not
hang; and the expert-paged engine gives the resident engine's transcripts.
The CPU cases hold the plain miss plan against ``make_fetch``'s
host-or-pool choice.
The JAX engines run with their watchdog and degradation ladder off and are
built once per module, with ``offload.pinned_host_sharding`` patched to
None from here (as in ``test_torch_paged.py``).
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.core import paging as jax_paging  # noqa: E402
from repro.core import residency as jax_residency  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import offload, paging, residency  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

TOL = 1e-5     # f32: both sides sum in f32, in another order


def _smoke(get, dtype="float32"):
    return dataclasses.replace(get("mixtral-8x7b").smoke(), dtype=dtype)


def _np(a):
    """numpy view of a tensor or jax array, bf16 as its bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tree_pairs(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_pairs(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _manifest_fields(m):
    d = dataclasses.asdict(m)
    d["leaves"] = [(tuple(e["path"]), tuple(e["shape"]), e["dtype"],
                    e["offset"]) for e in d["leaves"]]
    return d


# ------------------------------------------------------------------ packing

@pytest.fixture(scope="module")
def smoke_params():
    cfg = _smoke(get_config)
    params = init_params(cfg, jax.random.key(1))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,page_elems", [("float32", 4096),
                                              ("float32", 5000),
                                              ("bfloat16", 3000)])
def test_split_packing_matches_jax(dtype, page_elems):
    cfg = _smoke(get_config, dtype)
    blocks = jax.tree.map(np.asarray,
                          init_params(cfg, jax.random.key(2))["blocks"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        want = jax_paging.pack_block_groups_split(
            jax.tree.map(jnp.asarray, blocks), page_elems)
    tblocks = params_from_numpy(blocks, device="cpu")
    got = paging.pack_block_groups_split(tblocks, page_elems)
    assert sorted(got.pages) == sorted(want.pages)
    assert sorted(got.expert_pages) == sorted(want.expert_pages)
    for key in want.pages:
        assert _manifest_fields(got.manifests[key]) == \
            _manifest_fields(want.manifests[key])
        assert _manifest_fields(got.expert_manifests[key]) == \
            _manifest_fields(want.expert_manifests[key])
        np.testing.assert_array_equal(_np(got.pages[key]),
                                      _np(want.pages[key]))
        np.testing.assert_array_equal(_np(got.expert_pages[key]),
                                      _np(want.expert_pages[key]))
        assert got.shared_layer_bytes(key) == want.shared_layer_bytes(key)
        assert got.expert_manifests[key].span_bytes == \
            want.expert_manifests[key].span_bytes
        # the layer-by-layer writer against the stacked packers
        shared, experts, sm = paging.pack_layer_stack_split(tblocks[key],
                                                            page_elems)
        assert _manifest_fields(sm.shared) == \
            _manifest_fields(got.manifests[key])
        assert _manifest_fields(sm.experts) == \
            _manifest_fields(got.expert_manifests[key])
        assert torch.equal(shared, got.pages[key].reshape(-1, page_elems))
        assert torch.equal(experts, got.expert_pages[key])
        # unflattening rebuilds the layer's own leaves
        em = got.expert_manifests[key]
        for layer in range(em.num_layers):
            tree = paging.unflatten_span(got.pages[key][layer],
                                         got.manifests[key])
            for path, leaf in _tree_pairs(tree):
                node = tblocks[key]
                for p in path:
                    node = node[p]
                assert torch.equal(leaf, node[layer]), path
            span = paging.unflatten_expert_span(got.expert_pages[key][layer],
                                                em)
            for name in paging.EXPERT_LEAF_NAMES:
                assert torch.equal(span[name],
                                   tblocks[key]["moe"][name][layer])


def test_transfer_schedules_match_jax():
    for n, nub in ((0, 2), (1, 2), (7, 2), (10, 3), (5, 4)):
        assert paging.transfer_plan(n, nub) == \
            jax_paging.transfer_plan(n, nub)
        for pos in ([0], [1], [0, 1], [2, 5]):
            assert paging.window_plan(n, nub, pos) == \
                jax_paging.window_plan(n, nub, pos)
    rng = np.random.default_rng(3)
    pairs = [tuple(int(v) for v in p) for p in rng.integers(0, 4, (12, 2))]
    scores = [float(s) for s in rng.random(12)]
    assert paging.predicted_drain_order(pairs, scores) == \
        jax_paging.predicted_drain_order(pairs, scores)


# ------------------------------------------------------- routing compaction

@pytest.mark.parametrize("E,T,K,A", [(8, 1, 2, 2), (8, 3, 2, 6),
                                     (8, 16, 2, 8), (16, 2, 4, 8),
                                     (16, 3, 2, 10), (4, 5, 1, 4)])
def test_activated_experts_match_jax(E, T, K, A):
    rng = np.random.default_rng(E * 100 + T)
    for _ in range(5):
        idx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
        sel, imap, n = jax_moe.activated_experts(
            jnp.asarray(idx, jnp.int32), E, A)
        tsel, timap, tn = moe.activated_experts(torch.from_numpy(idx), E, A)
        assert tsel.dtype == timap.dtype == tn.dtype == torch.int32
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
        np.testing.assert_array_equal(timap.numpy(), np.asarray(imap))
        assert int(tn) == int(n)


# ------------------------------------------------------------------ gather

def _gather_inputs(seed, L=3, E=8, ppe=2, pe=48, slots=5, dtype=np.float32):
    """A seeded store, pool and resident map (some of the experts
    resident), and a manifest of two leaves filling the span."""
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(L, E, ppe, pe)).astype(dtype)
    pool = rng.normal(size=(slots, ppe, pe)).astype(dtype)
    rmap = np.full((L, E), -1, np.int32)
    flat = rng.choice(L * E, slots, replace=False)
    rmap.reshape(-1)[flat] = np.arange(slots, dtype=np.int32)
    n = ppe * pe
    dt = np.dtype(dtype).name
    em = paging.ExpertManifest(pe, n, ppe, L, E, [
        paging.LeafEntry(("wi",), (2, n // 4), dt, 0),
        paging.LeafEntry(("wo",), (n // 2,), dt, n // 2)], dt)
    return rng, store, pool, rmap, em


@pytest.mark.parametrize("T,K", [(1, 2), (2, 2), (6, 2)])
def test_expert_gather_plain_matches_make_fetch(T, K):
    rng, store, pool, rmap, em = _gather_inputs(T)
    jem = jax_paging.ExpertManifest(
        em.page_elems, em.expert_elems, em.pages_per_expert, em.num_layers,
        em.num_experts, [jax_paging.LeafEntry(e.path, e.shape, e.dtype,
                                              e.offset) for e in em.leaves],
        em.dtype)
    A = min(em.num_experts, T * K)
    for layer in range(em.num_layers):
        idx = np.stack([rng.choice(em.num_experts, K, replace=False)
                        for _ in range(T)])
        sel, _, n_act = moe.activated_experts(torch.from_numpy(idx),
                                              em.num_experts, A)
        want = jax_model._ExpertCtx(
            jnp.asarray(store), jem, jnp.asarray(pool),
            jnp.asarray(rmap)).make_fetch(layer)(jnp.asarray(sel.numpy()))
        before = ops.launch_counts()
        got = ops.expert_gather(torch.from_numpy(store),
                                torch.from_numpy(pool),
                                torch.from_numpy(rmap), layer, sel, n_act, em)
        assert ops.launch_counts() == before       # the plain version ran
        n = int(n_act)
        for name in ("wi", "wo"):
            assert got[name].is_contiguous()
            np.testing.assert_array_equal(got[name][:n].numpy(),
                                          np.asarray(want[name])[:n])
            assert not got[name][n:].any()
        # no resident map: every span from the host store
        host = model._ExpertCtx(torch.from_numpy(store), em).make_fetch(
            layer)(sel, n_act)
        np.testing.assert_array_equal(
            host["wo"][:n].numpy(),
            store[layer, sel[:n].numpy()].reshape(n, -1)[:, em.leaves[1]
                                                         .offset:])


PLAN_PATTERNS = ("none_resident", "all_resident", "mixed", "n_act_0",
                 "pad_slots")


def _plan_case(pattern, seed, L=3, E=8, ppe=2, pe=24):
    """A seeded store, a pool whose spans differ from every store span, a
    map for the pattern, and per layer a (sel, n_act): all E slots real,
    or (pad_slots) the few a 2-token routing activates, or none."""
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(L, E, ppe, pe)).astype(np.float32)
    rmap = np.full((L, E), -1, np.int32)
    if pattern == "all_resident":
        rmap.reshape(-1)[:] = rng.permutation(L * E)
    elif pattern != "none_resident":
        k = L * E // 2
        rmap.reshape(-1)[rng.choice(L * E, k, replace=False)] = \
            rng.permutation(k)
    slots = int(rmap.max()) + 1
    pool = (rng.normal(size=(max(1, slots), ppe, pe)) + 100.0) \
        .astype(np.float32) if slots else None
    cases = []
    for _ in range(L):
        if pattern == "n_act_0":
            sel, n_act = torch.zeros(E, dtype=torch.int32), torch.tensor(
                0, dtype=torch.int32)
        else:
            T = 2 if pattern == "pad_slots" else 4 * E
            idx = np.stack([rng.choice(E, 2, replace=False)
                            for _ in range(T)])
            sel, _, n_act = moe.activated_experts(torch.from_numpy(idx), E,
                                                  E)
        cases.append((sel, n_act))
    n = ppe * pe
    em = paging.ExpertManifest(pe, n, ppe, L, E, [
        paging.LeafEntry(("w",), (n,), "float32", 0)], "float32")
    return store, pool, rmap, em, cases


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pattern", PLAN_PATTERNS)
def test_expert_miss_plan_matches_make_fetch_choice(pattern, seed):
    """The plain miss plan names exactly the real slots whose span the JAX
    ``_ExpertCtx.make_fetch`` takes from the host store (told apart from
    the pool's by value), in slot order, with their expert ids."""
    store, pool, rmap, em, cases = _plan_case(pattern, seed)
    jem = jax_paging.ExpertManifest(
        em.page_elems, em.expert_elems, em.pages_per_expert, em.num_layers,
        em.num_experts, [jax_paging.LeafEntry(e.path, e.shape, e.dtype,
                                              e.offset) for e in em.leaves],
        em.dtype)
    jctx = jax_model._ExpertCtx(
        jnp.asarray(store), jem,
        None if pool is None else jnp.asarray(pool),
        None if pool is None else jnp.asarray(rmap))
    for layer, (sel, n_act) in enumerate(cases):
        got = ops.expert_miss_plan(torch.from_numpy(rmap), layer, sel, n_act)
        assert got.dtype == torch.int32 and got.shape[1:] == (2,)
        spans = np.asarray(jctx.make_fetch(layer)(jnp.asarray(sel.numpy()))
                           ["w"])
        want = []
        for a in range(int(n_act)):
            e = int(sel[a])
            host = np.array_equal(spans[a], store[layer, e].reshape(-1))
            assert host != (pool is not None and rmap[layer, e] >= 0 and
                            np.array_equal(spans[a],
                                           pool[rmap[layer, e]].reshape(-1)))
            if host:
                want.append((a, e))
        assert [tuple(r) for r in got.tolist()] == want
        if pattern == "all_resident" or pattern == "n_act_0":
            assert want == []
        if pattern == "none_resident":
            assert len(want) == int(n_act)


# --------------------------------------------------------------- moe_paged

def _moe_case(smoke_params, impl, T, seed):
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    blocks = smoke_params["blocks"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        pw = jax_paging.pack_block_groups_split(
            jax.tree.map(jnp.asarray, blocks), 4096)
    tpw = paging.pack_block_groups_split(
        params_from_numpy(blocks, device="cpu"), 4096)
    em = tpw.expert_manifests["p0"]
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(3, em.pages_per_expert, em.page_elems)) \
        .astype(np.float32)
    rmap = np.full((em.num_layers, em.num_experts), -1, np.int32)
    # three resident spans, their pool slots holding their true bytes
    for slot, (l, e) in enumerate(((0, 1), (1, 3), (0, 5))):
        rmap[l, e] = slot
        pool[slot] = np.asarray(pw.expert_pages["p0"][l, e])
    x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    out = []
    for layer in range(em.num_layers):
        p = jax.tree.map(lambda a: a[layer], blocks["p0"]["moe"])
        fetch = jax_model._ExpertCtx(pw.expert_pages["p0"],
                                     pw.expert_manifests["p0"],
                                     jnp.asarray(pool),
                                     jnp.asarray(rmap)).make_fetch(layer)
        want = jax_moe.moe_paged(
            cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
            fetch_experts=fetch,
            policy=JaxPolicy(moe_impl=impl, use_kernels=False))
        tp = params_from_numpy(p, device="cpu")
        tfetch = model._ExpertCtx(tpw.expert_pages["p0"], em,
                                  torch.from_numpy(pool),
                                  torch.from_numpy(rmap)).make_fetch(layer)
        got = moe.moe_paged(tcfg, tp, torch.from_numpy(x),
                            fetch_experts=tfetch,
                            policy=ExecPolicy(moe_impl=impl))
        out.append((got, want))
    return out


@pytest.mark.parametrize("impl", ["dense", "grouped"])
@pytest.mark.parametrize("T", [1, 3, 12])
def test_moe_paged_matches_jax(smoke_params, impl, T):
    for got, want in _moe_case(smoke_params, impl, T, seed=T):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(got[1]), float(want[1]),
                                   rtol=TOL, atol=TOL)
        assert got[2].dtype == torch.int32
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ----------------------------------------------------------- control plane

def _residency_state(r):
    return dict(slot_of=r.slot_of.tolist(), owner=r.owner.tolist(),
                free=list(r.free), pinned=sorted(r.pinned),
                replicas=sorted(r.replicas), protected=dict(r.protected),
                pred_unused=sorted(r._pred_unused), cause=dict(r.cause),
                popularity=r.popularity.tolist(),
                stall=r.miss_stall_bytes.tolist(), limit=r.limit,
                counters=dataclasses.asdict(r.counters))


def test_residency_and_predictor_trace_matches_jax():
    L, E = 4, 8
    kw = dict(capacity=9, span_bytes=1000, alpha=0.3, victim_quota=1,
              replicate_frac=0.34, replica_exit=0.5, replica_warmup=3,
              protect_ttl=2)
    pair = [jax_residency.ExpertResidency(L, E, **kw),
            residency.ExpertResidency(L, E, **kw)]
    preds = [jax_residency.GatePredictor(L, E),
             residency.GatePredictor(L, E)]
    assert residency.slots_from_ratio(0.3, L, E) == \
        jax_residency.slots_from_ratio(0.3, L, E)
    rng = np.random.default_rng(11)
    for step in range(60):
        counts = rng.poisson(0.6, (L, E)) * (rng.random((L, E)) < 0.5)
        op = rng.choice(["observe", "window", "admit", "pin", "unpin",
                         "replicas", "limit"])
        res_mask = rng.random((L, E)) < 0.3
        hid = rng.random((L, E)) < 0.1
        l, e = int(rng.integers(L)), int(rng.integers(E))
        cause = str(rng.choice(["router", "predicted", "replica"]))
        pri = float(rng.random()) if rng.random() < 0.5 else None
        limit = int(rng.integers(3, 9)) if step % 2 else None
        out = []
        for r, gp in zip(pair, preds):
            r.begin_chunk()
            if op == "observe":
                out.append(r.observe(counts > 0, token_counts=counts,
                                     resident_mask=res_mask,
                                     hidden_mask=hid))
            elif op == "window":
                win = np.stack([counts, counts[::-1]])
                out.append(r.observe_window(win > 0, token_counts=win))
            elif op == "admit":
                out.append((r.admit(l, e, cause=cause, priority=pri),
                            r.admit(e % L, l, demand=True,
                                    allow_evict=False)))
            elif op == "pin":
                r.pin_resident()
                r.pin([(l, e)])
            elif op == "unpin":
                r.unpin_all()
            elif op == "replicas":
                out.append(r.update_replicas())
            else:
                out.append((r.set_limit(limit),
                            r.drop_replicas() if step % 3 == 0 else 0))
            out.append(gp.fit_step(counts))
            out.append(gp.predict(counts, lookahead=2,
                                  topk=None if step % 2 else 3))
        half = len(out) // 2
        assert out[:half] == out[half:], (step, op)
        assert _residency_state(pair[0]) == _residency_state(pair[1]), \
            (step, op)
        np.testing.assert_array_equal(preds[0].W, preds[1].W)
        assert preds[0].acc == preds[1].acc
    c = pair[1].counters
    assert c.hits and c.misses and c.prefetches and c.evictions
    assert c.replications and c.predicted_prefetches


# ------------------------------------------------------------------ engine

LENS = (5, 14, 3, 40, 9, 20)
QUOTAS = (6, 3, 9, 9, 5, 7)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4,
             expert_paged=True, page_elems=4096)
RUNS = {"r1": dict(w_gpu_ratio=1.0),
        "slots1": dict(expert_slots=1),
        "r025": dict(w_gpu_ratio=0.25),
        "r025_grouped": dict(w_gpu_ratio=0.25),
        "noprefetch": dict(w_gpu_ratio=0.25, prefetch=False),
        "nointra": dict(w_gpu_ratio=0.25, intra_pass=False),
        "replicate": dict(w_gpu_ratio=0.25, replicate_frac=0.25),
        "nopredict": dict(w_gpu_ratio=0.25, predict=False),
        "knobs": dict(w_gpu_ratio=0.25, residency_alpha=0.5,
                      residency_victim_quota=0, predict_lookahead=1,
                      predict_topk=2, replicate_frac=0.25, replica_exit=0.8)}


def _impl(run):
    return "grouped" if run in ("r025_grouped", "replicate") else "dense"


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(out={r: eng.scheduler.requests[r].generated for r in rids},
                histories=[s.history for s in slots],
                traffic=eng.weight_traffic(), tokens_out=eng.tokens_out)


@pytest.fixture(scope="module")
def jax_runs(smoke_params):
    cfg = _smoke(get_config)
    params = jax.tree.map(jnp.asarray, smoke_params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in LENS]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, kw in RUNS.items():
            eng = JaxEngine(cfg, params, JaxEngineConfig(
                **SLOTS, **kw, watchdog=False, degrade=False),
                JaxPolicy(moe_impl=_impl(name), use_kernels=False))
            rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return dict(prompts=prompts, runs=runs)


def _port_run(smoke_params, prompts, ecfg, impl):
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(smoke_params, device="cpu"), ecfg,
                 ExecPolicy(moe_impl=impl), device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
    eng.run_until_idle()
    return eng, _record(eng, rids)


@pytest.mark.parametrize("run", list(RUNS))
def test_expert_engine_matches_jax(smoke_params, jax_runs, run):
    eng, got = _port_run(smoke_params, jax_runs["prompts"],
                         EngineConfig(**SLOTS, **RUNS[run]), _impl(run))
    want = jax_runs["runs"][run]
    assert got["out"] == want["out"]
    assert got["histories"] == want["histories"]
    assert got["tokens_out"] == want["tokens_out"]
    assert got["traffic"] == want["traffic"]
    assert all(len(got["out"][r]) == q
               for r, q in zip(got["out"], QUOTAS))
    tr = got["traffic"]
    assert tr["mode"] == "expert_paged"
    assert tr["h2d_bytes"] == tr["shared_bytes"] + tr["expert_bytes"]
    if run == "r1":
        assert tr["prefetches"] == 0
    else:
        assert tr["misses"] > 0 and tr["evictions"] > 0
    assert (tr["prefetches"] > 0) == (run not in ("r1", "noprefetch"))
    if run in ("replicate", "knobs"):
        assert tr["replications"] > 0
    if run == "nopredict":
        assert tr["predicted_prefetches"] == 0 == tr["predictor_accuracy"]
    for key, r in eng.residency.items():
        assert r.occupancy() <= r.capacity and not r.pinned
        # every resident span's pool slot holds its true bytes
        pool = eng._expert_pool[key]
        store = eng.paged_blocks.expert_pages[key]
        for slot, pid in enumerate(r.owner):
            if pid >= 0:
                assert torch.equal(pool[slot], store[divmod(int(pid),
                                                           r.num_experts)])


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_expert_engine_matches_resident_engine(smoke_params, jax_runs, impl):
    kw = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)
    resident, want = _port_run(smoke_params, jax_runs["prompts"],
                               EngineConfig(**kw), impl)
    assert resident.weight_traffic()["mode"] == "resident"
    _, got = _port_run(smoke_params, jax_runs["prompts"],
                       EngineConfig(**kw, expert_paged=True,
                                    page_elems=4096, w_gpu_ratio=0.25), impl)
    assert got["out"] == want["out"]
    assert got["histories"] == want["histories"]


def test_expert_paged_with_kv_paged_raises(smoke_params):
    """The pair no longer raises: the engine builds both control planes
    and reports both traffic dicts (``test_torch_pair.py`` holds the pair
    against the JAX engine)."""
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(smoke_params, device="cpu"),
                 EngineConfig(expert_paged=True, kv_paged=True),
                 device="cpu")
    assert eng.residency and eng._kv is not None
    assert eng.weight_traffic()["mode"] == "expert_paged"
    assert eng.kv_traffic()["mode"] == "kv_paged"


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_store(dev, store_np, dtype):
    store = offload.weight_store(store_np.shape, dtype, dev)
    store.copy_(torch.from_numpy(store_np).to(dtype))
    return store


def _assert_gather(got, want, n):
    for name in got:
        assert got[name].is_contiguous()
        assert torch.equal(got[name], want[name]), name
    assert not any(bool(t[n:].any()) for t in got.values())


def _card_gather(dev, store_np, pool_np, rmap, em, layer, sel, n_act,
                 dtype):
    store = _card_store(dev, store_np, dtype)
    try:
        pool = (None if pool_np is None
                else torch.from_numpy(pool_np).to(dtype).to(dev))
        args = (store, pool, torch.from_numpy(rmap).to(dev), layer,
                sel.to(dev), n_act.to(dev), em)
        got = ops.expert_gather(*args)
        _assert_gather(got, ref.expert_gather_ref(*args), int(n_act))
    finally:
        offload.release(store)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pe,T", [(48, 1), (48, 6), (37, 3), (50, 2)])
def test_expert_gather_cuda_matches_plain(cuda_device, dtype, pe, T):
    """Odd shapes: page widths whose spans and leaves are not multiples of
    16 bytes take the element-wide body; pad slots; a resident mix."""
    rng, store, pool, rmap, em = _gather_inputs(pe + T, pe=pe)
    dt = getattr(torch, dtype)
    em = dataclasses.replace(em, dtype=dtype, leaves=[
        dataclasses.replace(e, dtype=dtype) for e in em.leaves])
    A = min(em.num_experts, T * 2)
    for layer in range(em.num_layers):
        idx = np.stack([rng.choice(em.num_experts, 2, replace=False)
                        for _ in range(T)])
        sel, _, n_act = moe.activated_experts(torch.from_numpy(idx),
                                              em.num_experts, A)
        _card_gather(cuda_device, store, pool, rmap, em, layer, sel, n_act,
                     dt)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["all_resident", "none_resident",
                                     "mixed", "pad_slots", "n_act_0"])
@pytest.mark.parametrize("pe", [24, 37, 50])
def test_expert_gather_cuda_miss_patterns(cuda_device, pattern, pe):
    """No miss (no copy), every slot a miss (no pool), a mix, pad slots and
    no real slot, at page widths that take the 16-byte body (24 f32) and
    the element-wide one (37, 50), over three layers."""
    store, pool, rmap, em, cases = _plan_case(pattern, pe, pe=pe)
    for layer, (sel, n_act) in enumerate(cases):
        _card_gather(cuda_device, store, pool, rmap, em, layer, sel, n_act,
                     torch.float32)


@pytest.mark.cuda
def test_expert_gather_cuda_back_to_back(cuda_device):
    """28 layers back to back, twice, with a new sel each layer, enqueued
    behind a held stream: each call's plan and copies belong to it alone,
    so every layer's outputs equal its plain version."""
    L, E, ppe, pe = 28, 8, 4, 4096
    rng = np.random.default_rng(28)
    store_np = rng.normal(size=(L, E, ppe, pe)).astype(np.float32)
    rmap_np = np.full((L, E), -1, np.int32)
    flat = rng.choice(L * E, 64, replace=False)
    rmap_np.reshape(-1)[flat] = np.arange(64, dtype=np.int32)
    n = ppe * pe
    em = paging.ExpertManifest(pe, n, ppe, L, E, [
        paging.LeafEntry(("wi",), (2, n // 4), "float32", 0),
        paging.LeafEntry(("wo",), (n // 2,), "float32", n // 2)], "float32")
    dev = cuda_device
    store = _card_store(dev, store_np, torch.float32)
    try:
        pool = torch.from_numpy(rng.normal(size=(64, ppe, pe)).astype(
            np.float32)).to(dev)
        for l, e in zip(*np.nonzero(rmap_np >= 0)):
            pool[rmap_np[l, e]].copy_(torch.from_numpy(store_np[l, e]))
        rmap = torch.from_numpy(rmap_np).to(dev)
        calls = []
        for _ in range(2):
            for layer in range(L):
                T = int(rng.integers(1, 6))
                idx = np.stack([rng.choice(E, 2, replace=False)
                                for _ in range(T)])
                sel, _, n_act = moe.activated_experts(
                    torch.from_numpy(idx), E, min(E, 2 * T))
                calls.append((layer, sel.to(dev), n_act.to(dev)))
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        outs = [ops.expert_gather(store, pool, rmap, layer, sel, n_act, em)
                for layer, sel, n_act in calls]
        torch.cuda.synchronize()
        for (layer, sel, n_act), got in zip(calls, outs):
            want = ref.expert_gather_ref(store, pool, rmap, layer, sel,
                                         n_act, em)
            _assert_gather(got, want, int(n_act))
    finally:
        offload.release(store)


@pytest.mark.cuda
def test_expert_gather_cuda_blocking_calls_after_gather(cuda_device):
    """The wrapper waits for the device to reach the gather (here behind
    ``torch.cuda._sleep``), and host calls that block inside CUDA right
    after it, while its copies may be in flight — a pageable read,
    ``empty_cache``, a pageable upload — return: no thread of the kernel
    library has to issue anything for them to finish."""
    store_np, pool_np, rmap_np, em, cases = _plan_case("mixed", 7, pe=40)
    dev = cuda_device
    store = _card_store(dev, store_np, torch.float32)
    try:
        pool = torch.from_numpy(pool_np).to(dev)
        rmap = torch.from_numpy(rmap_np).to(dev)
        sel, n_act = cases[0][0].to(dev), cases[0][1].to(dev)
        assert int(ops.expert_miss_plan(rmap, 0, sel, n_act).shape[0]) > 0
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)              # ~1 s
        t0 = time.perf_counter()
        got = ops.expert_gather(store, pool, rmap, 0, sel, n_act, em)
        returned = time.perf_counter() - t0
        sel_host = sel.cpu()
        torch.cuda.empty_cache()
        up = torch.tensor(sel_host.tolist(), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        assert returned > 0.1, returned
        assert torch.equal(up, sel)
        _assert_gather(got, ref.expert_gather_ref(
            store, pool, rmap, 0, sel, n_act, em), int(n_act))
    finally:
        offload.release(store)


@pytest.mark.cuda
def test_expert_engine_cuda_matches_resident(cuda_device, smoke_params):
    """The expert-paged engine on the card (the gather, the shared spans'
    two-slot buffer, the static map) gives the resident engine's
    transcripts."""
    params = params_from_numpy(smoke_params, device=cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 256, n) for n in (5, 30, 17, 60, 9, 44)]
    runs = []
    for kw in ({}, dict(expert_paged=True, page_elems=4096,
                        w_gpu_ratio=0.25)):
        eng = Engine(_smoke(t_get_config), params,
                     EngineConfig(ubatch=2, num_ubs=2, max_seq=128,
                                  decode_chunk=4, **kw),
                     ExecPolicy(moe_impl="grouped", use_kernels=True),
                     device=cuda_device)
        try:
            rids = [eng.submit(p, 12) for p in prompts]
            out = eng.run_until_idle()
            runs.append([out[r] for r in rids])
        finally:
            if eng.paged_blocks is not None:
                eng.paged_blocks.release()
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_expert_gather_cuda_served_span(cuda_device):
    """mixtral-8x7b's span (d_model 4096, d_ff 14336, pages of 65536: 2688
    pages, 352 MB in bf16) for one layer of 8 experts, 3 of them resident,
    5 activated and 3 pad slots."""
    cfg = t_get_config("mixtral-8x7b")
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    blocks = {"p0": {"moe": {
        "router": torch.empty((1, D, E), dtype=torch.bfloat16,
                              device="meta"),
        "wi": torch.empty((1, E, D, 2, F), dtype=torch.bfloat16,
                          device="meta"),
        "wo": torch.empty((1, E, F, D), dtype=torch.bfloat16,
                          device="meta")}}}
    pw = paging.PagedWeights.empty(blocks, 1 << 16, cuda_device)
    try:
        em = pw.expert_manifests["p0"]
        assert em.pages_per_expert == 2688
        g = torch.Generator(device=cuda_device).manual_seed(0)
        for e in range(E):
            wi = torch.empty((D, 2, F), dtype=torch.bfloat16,
                             device=cuda_device).normal_(generator=g)
            wo = torch.empty((F, D), dtype=torch.bfloat16,
                             device=cuda_device).normal_(generator=g)
            pw.expert_pages["p0"][0, e].view(-1)[:wi.numel() + wo.numel()] \
                .copy_(torch.cat([wi.reshape(-1), wo.reshape(-1)]))
        store = pw.expert_pages["p0"]
        pool = torch.empty((3,) + tuple(store.shape[2:]),
                           dtype=torch.bfloat16, device=cuda_device)
        rmap = torch.full((1, E), -1, dtype=torch.int32, device=cuda_device)
        for slot, e in enumerate((1, 4, 6)):
            pool[slot].copy_(store[0, e])
            rmap[0, e] = slot
        sel = torch.tensor([0, 1, 4, 5, 6, 0, 0, 0], dtype=torch.int32,
                           device=cuda_device)
        n_act = torch.tensor(5, dtype=torch.int32, device=cuda_device)
        args = (store, pool, rmap, 0, sel, n_act, em)
        got = ops.expert_gather(*args)
        want = ref.expert_gather_ref(*args)
        torch.cuda.synchronize()
        assert got["wi"].shape == (8, D, 2, F) and got["wo"].shape == (8, F, D)
        for name in got:
            assert torch.equal(got[name], want[name]), name
            assert not got[name][5:].any()
    finally:
        pw.release()
