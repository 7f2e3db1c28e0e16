"""Module-based batching in the port against the JAX package's.

  * The staged MoE: ``moe_grouped``, ``_grouped_subset`` and ``moe_paged``
    with ``token_groups`` G in {2, 3} against the JAX functions on the same
    seeded inputs (float32, within 1e-5; counts equal), and each window's
    output equal to G separate port calls.
  * ``split_slot_cache`` / ``slot_rows``: the groups as views of one pool
    cache, cut as the JAX package cuts a window, and the JAX
    ``concat_slot_caches`` of the parts gives the pool back.
  * Engine: mixtral smoke in float32; greedy transcripts, slot histories
    and the whole ``weight_traffic()`` and ``kv_traffic()`` dicts equal the
    JAX engine's over the dense ring at G = 2, at num_ubs 3 with a
    lockstep remainder, over the paged arena at r_c 1.0 and 0.25,
    expert-paged at r_w 0.25 (predict and intra_pass on), and with
    ``module_stage_tokens`` clamping the window to one group; the window
    runs' transcripts equal the port's lockstep runs, except at r_c 0.25,
    where the window's wider protect set preempts other requests (in the
    reference's engine too).
  * The amortization: at r_w 0.25, four groups a window move at most half
    the expert bytes per token of lockstep, with equal transcripts (the
    port's mirror of ``test_module_batch.py``).

On the card (marker ``cuda``): a window's decode forward at mixtral's
served width gives every row the bits of its lockstep call, and the
engine's windows give the lockstep transcripts in bf16 through the
kernels.  The JAX engines run with their watchdog and degradation ladder
off, with ``offload.pinned_host_sharding`` patched to None (as in
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
from repro.models import kvcache as jax_kvcache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import paging  # noqa: E402
from repro_torch.models import kvcache, model, moe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

TOL = 1e-5     # f32: both sides sum in f32, in another order


def _smoke(get, dtype="float32"):
    return dataclasses.replace(get("mixtral-8x7b").smoke(), dtype=dtype)


@pytest.fixture(scope="module")
def smoke_params():
    cfg = _smoke(get_config)
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.key(7)))


def _layer(smoke_params, i=0):
    return jax.tree.map(lambda a: a[i], smoke_params["blocks"]["p0"]["moe"])


# ------------------------------------------------------------ staged MoE

@pytest.mark.parametrize("G", [2, 3])
def test_moe_grouped_token_groups_matches_jax(smoke_params, G):
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    p = _layer(smoke_params)
    x = np.random.default_rng(G).normal(size=(G * 4, cfg.d_model)) \
        .astype(np.float32)
    want = jax_moe.moe_grouped(cfg, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x), token_groups=G)
    tp = params_from_numpy(p, device="cpu")
    got = moe.moe_grouped(tcfg, tp, torch.from_numpy(x), token_groups=G)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]),
                               rtol=TOL, atol=TOL)
    for g in range(G):
        rows = slice(g * 4, (g + 1) * 4)
        alone, _ = moe.moe_grouped(tcfg, tp, torch.from_numpy(x[rows]))
        assert torch.equal(got[0][rows], alone)


def _paged_case(smoke_params, G, seed, impl, rows):
    """moe_paged of both packages at token_groups G on one layer, the
    spans read through each package's own fetch (three resident)."""
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
    pool = np.zeros((3, em.pages_per_expert, em.page_elems), np.float32)
    rmap = np.full((em.num_layers, em.num_experts), -1, np.int32)
    for slot, (l, e) in enumerate(((0, 1), (1, 3), (0, 5))):
        rmap[l, e] = slot
        pool[slot] = np.asarray(pw.expert_pages["p0"][l, e])
    x = rng.normal(size=(G * rows, cfg.d_model)).astype(np.float32)
    p = _layer(smoke_params)
    fetch = jax_model._ExpertCtx(pw.expert_pages["p0"],
                                 pw.expert_manifests["p0"], jnp.asarray(pool),
                                 jnp.asarray(rmap)).make_fetch(0)
    want = jax_moe.moe_paged(
        cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        fetch_experts=fetch, token_groups=G,
        policy=JaxPolicy(moe_impl=impl, use_kernels=False))
    tp = params_from_numpy(p, device="cpu")
    tfetch = model._ExpertCtx(tpw.expert_pages["p0"], em,
                              torch.from_numpy(pool),
                              torch.from_numpy(rmap)).make_fetch(0)

    def port(xs, groups):
        return moe.moe_paged(tcfg, tp, torch.from_numpy(xs),
                             fetch_experts=tfetch, token_groups=groups,
                             policy=ExecPolicy(moe_impl=impl))
    return x, want, port


@pytest.mark.parametrize("impl", ["dense", "grouped"])
@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("rows", [3, 4])
def test_moe_paged_token_groups_matches_jax(smoke_params, G, impl, rows):
    """``moe_paged`` (and through it ``_grouped_subset`` or
    ``_dense_subset``) at token_groups G: outputs within 1e-5 of the
    reference, counts (G, E) equal, and each group's rows equal a call of
    its own, whose counts are that group's row of the window's.  At 4 rows
    a group (a capacity of 2, all 8 experts active) the call alone has the
    window's shapes per group and its bits; at 3 rows (a capacity of 1,
    6 experts alone) the CPU's BLAS multiplies the lone bucket row by
    another routine than the window's two, so that case is held within
    1e-5."""
    x, want, port = _paged_case(smoke_params, G, seed=10 + G, impl=impl,
                                rows=rows)
    got = port(x, G)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    assert got[2].shape == (G, 8) and got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g in range(G):
        sl = slice(g * rows, (g + 1) * rows)
        alone = port(x[sl], None)
        if rows == 4:
            assert torch.equal(got[0][sl], alone[0])
        else:
            np.testing.assert_allclose(got[0][sl].numpy(),
                                       alone[0].numpy(), rtol=TOL, atol=TOL)
        assert torch.equal(got[2][g], alone[2])


@pytest.mark.parametrize("G", [2, 3])
def test_grouped_subset_token_groups_matches_jax(smoke_params, G):
    """``_grouped_subset`` alone, on a compacted subset of the layer's
    experts routed by both packages' routers."""
    cfg, tcfg = _smoke(get_config), _smoke(t_get_config)
    p = _layer(smoke_params)
    x = np.random.default_rng(20 + G).normal(size=(G * 5, cfg.d_model)) \
        .astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    w, idx, _ = jax_moe.route(cfg, jp["router"], jnp.asarray(x))
    sel, index_map, _ = jax_moe.activated_experts(idx, cfg.num_experts,
                                                  cfg.num_experts)
    ep = {"wi": jp["wi"][sel], "wo": jp["wo"][sel]}
    want = jax_moe._grouped_subset(cfg, ep, jnp.asarray(x), w, idx,
                                   index_map, token_groups=G)
    tp = params_from_numpy(p, device="cpu")
    tw, tidx, _ = moe.route(tcfg, tp["router"], torch.from_numpy(x), G)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    tsel, tmap, _ = moe.activated_experts(tidx, tcfg.num_experts,
                                          tcfg.num_experts)
    tep = {"wi": tp["wi"][tsel.long()], "wo": tp["wo"][tsel.long()]}
    got = moe._grouped_subset(tcfg, tep, torch.from_numpy(x), tw, tidx,
                              tmap, token_groups=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


# ------------------------------------------------------- window caches

def _filled_cache(cfg, batch, seed, **kw):
    cache = kvcache.init_cache(cfg, batch, 32, device="cpu", **kw)
    g = torch.Generator().manual_seed(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif v.dtype.is_floating_point:
                v.copy_(torch.randn(v.shape, generator=g))
            else:
                v.copy_(torch.randint(-1, 30, v.shape, generator=g))
    fill(cache)
    return cache


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


@pytest.mark.parametrize("arch,G", [("mixtral-8x7b", 2),
                                    ("mixtral-8x7b", 3),
                                    ("deepseek-v3-671b", 2)])
def test_concat_split_slot_caches_round_trip(arch, G):
    """The port's groups are views of one pool cache: ``split_slot_cache``
    cuts it as the JAX package's does, and JAX's ``concat_slot_caches`` of
    the parts gives the pool back."""
    tcfg = dataclasses.replace(t_get_config(arch).smoke(), dtype="float32")
    window = _filled_cache(tcfg, 2 * G, G)
    parts = kvcache.split_slot_cache(window, G)
    assert len(parts) == G
    want = jax_kvcache.split_slot_cache(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), window), G)
    for part, ref in zip(parts, want):
        assert part["pos"].shape == (2,)
        got_leaves = dict(_leaves(part))
        assert len(got_leaves) == len(list(_leaves(ref)))
        for path, leaf in _leaves(ref):
            np.testing.assert_array_equal(got_leaves[path].numpy(),
                                          np.asarray(leaf))
    back = jax_kvcache.concat_slot_caches(
        [jax.tree.map(lambda t: jnp.asarray(t.numpy()), c) for c in parts])
    got_leaves = dict(_leaves(back))
    for path, leaf in _leaves(window):
        np.testing.assert_array_equal(np.asarray(got_leaves[path]),
                                      leaf.numpy())


def test_split_slot_cache_is_a_view_of_the_window():
    tcfg = _smoke(t_get_config)
    window = _filled_cache(tcfg, 4, 0)
    part = kvcache.split_slot_cache(window, 2)[1]
    kvcache.reset_slot(part, 0)
    assert int(window["pos"][2]) == 0
    assert bool((window["p0"]["slot_pos"][:, 2] == -1).all())
    rows = kvcache.slot_rows(window, 1, 2)
    assert rows["p0"]["k"].data_ptr() == window["p0"]["k"][:, 1].data_ptr()
    assert torch.equal(rows["pos"], window["pos"][1:3])


# ------------------------------------------------------------------ engine

LENS = (5, 14, 3, 40, 9, 20, 11)
QUOTAS = (6, 3, 9, 9, 5, 7, 8)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)
RUNS = {
    "dense_g2": dict(module_batch=True),
    "dense_ubs3": dict(module_batch=True, module_groups=2, num_ubs=3),
    "kv_rc1": dict(module_batch=True, kv_paged=True, kv_gpu_ratio=1.0),
    "kv_rc025": dict(module_batch=True, kv_paged=True, kv_gpu_ratio=0.25),
    "expert_rw025": dict(module_batch=True, expert_paged=True,
                         page_elems=4096, w_gpu_ratio=0.25, predict=True,
                         intra_pass=True),
    "stage_cap": dict(module_batch=True, module_stage_tokens=3),
}


def _lockstep(kw):
    return {k: v for k, v in kw.items()
            if k not in ("module_batch", "module_groups",
                         "module_stage_tokens")}


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(out={r: eng.scheduler.requests[r].generated for r in rids},
                histories=[s.history for s in slots],
                weight=eng.weight_traffic(), kv=eng.kv_traffic(),
                tokens_out=eng.tokens_out)


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
                **{**SLOTS, **kw}, watchdog=False, degrade=False),
                JaxPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return dict(prompts=prompts, runs=runs)


def _port_run(smoke_params, prompts, kw, policy=None):
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(smoke_params, device="cpu"),
                 EngineConfig(**{**SLOTS, **kw}),
                 policy or ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
    eng.run_until_idle()
    return eng, _record(eng, rids)


@pytest.mark.parametrize("run", list(RUNS))
def test_module_engine_matches_jax(smoke_params, jax_runs, run):
    kw = RUNS[run]
    eng, got = _port_run(smoke_params, jax_runs["prompts"], kw)
    want = jax_runs["runs"][run]
    assert got == want
    assert all(len(got["out"][r]) == q for r, q in zip(got["out"], QUOTAS))
    w = got["weight"]
    if run == "stage_cap":
        assert eng._mg == 1 and not w["module_batch"]
    else:
        assert eng._mg == 2 and w["module_batch"] and w["module_groups"] == 2
    if run == "dense_ubs3":
        assert eng._windows == [[0, 1], [2]]
    if run == "kv_rc025":
        kv = got["kv"]
        # a window spans both groups, so no group waits for a prefetch
        assert kv["spills"] > 0 and kv["misses"] > 0
        eng._kv.check_invariants()
    if run == "expert_rw025":
        assert w["misses"] > 0 and w["predicted_prefetches"] > 0
        assert w["module_groups_effective"] > 1.0
    if run == "kv_rc025":
        # a window's protect set spans both groups, so the arena preempts
        # other requests than lockstep does (the reference's engine too),
        # and a preemption changes who shares a capacity bucket: here only
        # the parity above holds
        return
    # the window schedule's transcripts are the lockstep schedule's
    _, lock = _port_run(smoke_params, jax_runs["prompts"], _lockstep(kw))
    assert got["out"] == lock["out"]


def test_module_batch_halves_expert_traffic(smoke_params):
    """At the same r_w, four groups a window move at most half the
    expert-phase bytes per token of the router-ahead lockstep path (the
    gate predictor and intra-pass accounting off, as in the reference's
    test), with equal transcripts, and the counter-derived amortization
    agrees with the byte ratio."""
    tcfg = _smoke(t_get_config)
    rng = np.random.default_rng(0)
    work = [(rng.integers(2, tcfg.vocab_size, int(rng.integers(2, 6))),
             int(rng.integers(16, 25))) for _ in range(16)]
    kw = dict(ubatch=4, num_ubs=4, max_seq=64, decode_chunk=4,
              expert_paged=True, page_elems=4096, w_gpu_ratio=0.25,
              predict=False, intra_pass=False)
    outs, engs = [], []
    for extra in ({}, dict(module_batch=True, module_groups=4)):
        eng = Engine(tcfg, params_from_numpy(smoke_params, device="cpu"),
                     EngineConfig(**kw, **extra), device="cpu")
        for prompt, quota in work:
            eng.submit(prompt, quota)
        outs.append(eng.run_until_idle())
        assert all(r.done for r in eng.scheduler.requests.values())
        engs.append(eng)
    assert outs[0] == outs[1]
    tl, tw = (e.weight_traffic() for e in engs)
    assert tl["module_groups"] == 1 and tw["module_groups"] == 4
    per_tok_l = tl["expert_phase_bytes"] / engs[0].tokens_out
    per_tok_w = tw["expert_phase_bytes"] / engs[1].tokens_out
    assert per_tok_l >= 2.0 * per_tok_w, (per_tok_l, per_tok_w)
    assert tw["module_groups_effective"] >= 2.0
    assert tw["module_groups_effective"] == pytest.approx(
        tl["expert_phase_bytes"] / tw["expert_phase_bytes"], rel=0.35)
    assert tw["bytes_per_token_amortized"] < tl["bytes_per_token_amortized"]


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_window_forward_cuda_rows_match_lockstep(cuda_device):
    """One decode step at mixtral's served width (1 layer, bf16, the
    kernels): a window of 2 groups of 8 rows gives each row the bits of
    its group's own call (cuBLAS picks its reduction by the row count, so
    the window's row-wise work runs group by group)."""
    from repro_torch.models.params import init_params as t_init_params
    cfg = dataclasses.replace(t_get_config("mixtral-8x7b"), num_layers=1)
    params = t_init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    pol = ExecPolicy(moe_impl="grouped", use_kernels=True)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    # the engine's layout: the groups are views of one pool cache, and
    # the window is the pool; each group's own call runs on a copy
    window = kvcache.init_cache(cfg, 16, 256, device=cuda_device)
    caches = []
    for part in kvcache.split_slot_cache(window, 2):
        tok = torch.randint(2, cfg.vocab_size, (8, 96), generator=g,
                            device=cuda_device)
        out = model.forward(cfg, params, tok, cache=dict(part),
                            mode="prefill", policy=pol)
        part["pos"].copy_(out["cache"]["pos"])
        caches.append(_clone(part))
    tok = torch.randint(2, cfg.vocab_size, (16, 1), generator=g,
                        device=cuda_device)
    out = model.forward(cfg, params, tok, cache=window, mode="decode",
                        policy=pol, token_groups=2)
    logits = model.unembed(cfg, params, out["hidden"][:, -1], 2)
    for j, c in enumerate(caches):
        rows = slice(8 * j, 8 * (j + 1))
        alone = model.forward(cfg, params, tok[rows], cache=c,
                              mode="decode", policy=pol)
        assert torch.equal(out["hidden"][rows], alone["hidden"])
        assert torch.equal(
            logits[rows], model.unembed(cfg, params, alone["hidden"][:, -1]))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(kv_paged=True, kv_gpu_ratio=1.0),
                                dict(expert_paged=True, page_elems=4096,
                                     w_gpu_ratio=0.25)])
def test_module_engine_cuda_matches_lockstep(cuda_device, kw):
    """bf16 through the kernels: the window schedule's transcripts equal
    the lockstep schedule's (the paged arena at r_c 1.0: below it, the
    window's wider protect set preempts other requests, which changes
    who shares a capacity bucket, in the reference's engine too)."""
    from repro_torch.models.params import init_params as t_init_params
    cfg = _smoke(t_get_config, "bfloat16")
    params = t_init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 256, n) for n in (5, 30, 17, 60, 9, 44, 21)]
    runs = []
    for mb in (False, True):
        eng = Engine(cfg, params,
                     EngineConfig(ubatch=2, num_ubs=2, max_seq=128,
                                  decode_chunk=4, module_batch=mb, **kw),
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
