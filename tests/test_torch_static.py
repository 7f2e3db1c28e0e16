"""The port's static micro-batch mode and whole-layer paged weights against
the JAX package's.

  * Engine: mixtral smoke in float32, the grouped MoE; greedy transcripts
    and the whole ``weight_traffic()`` and ``kv_traffic()`` dicts equal the
    JAX engine's in the static variants of ``test_engine_fuzz.py``
    (``static``, ``module_static``, ``kv_static`` and ``kv_module_static``
    at r_c 0.25, ``expert_static``, ``expert_module_static``,
    ``expert_predict_static``) and with whole-layer paged weights
    (``paged_layer``) in continuous and in static mode.
  * A micro-batch reuses its rotation group's rows of the slot pool (the
    reference allocates a fresh cache): a later, shorter micro-batch in the
    rows a longer one left gives the reference's transcripts, and those of
    an engine that serves it alone.
  * Within the port, with the dense MoE (no capacity drops, so the batch
    a token shares cannot change it), static transcripts equal continuous
    ones in every layout.
  * ``pack_block_groups`` equals the reference's pages and manifests bit
    for bit.
  * The port's ``test_static_admission_books_against_block_arena``.

On the card (marker ``cuda``): whole-layer paged weights stream from
page-locked stores and give the resident engine's transcripts, in
continuous and in static mode, in bf16 through the kernels.  The JAX
engines run with their watchdog and degradation ladder off, built once per
module, with ``offload.pinned_host_sharding`` patched to None from here
(as in ``test_torch_expert.py``).
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
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import paging  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402


def _mixtral(get):
    return dataclasses.replace(get("mixtral-8x7b").smoke(), dtype="float32")


def _qwen(get):
    return dataclasses.replace(get("qwen2.5-3b").smoke(), dtype="float32")


@pytest.fixture(scope="module")
def smoke_params():
    return jax.tree.map(np.asarray,
                        init_params(_mixtral(get_config), jax.random.key(4)))


def test_whole_layer_packing_matches_jax(smoke_params):
    blocks = smoke_params["blocks"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        pages, manifests = jax_paging.pack_block_groups(
            jax.tree.map(jnp.asarray, blocks), 4096)
    pw = paging.pack_block_groups(params_from_numpy(blocks, device="cpu"),
                                  4096)
    assert not pw.expert_manifests and not pw.expert_pages
    assert sorted(pw.pages) == sorted(pages)
    for key, m in manifests.items():
        got = pw.manifests[key]
        assert dataclasses.asdict(got) == dataclasses.asdict(m)
        np.testing.assert_array_equal(pw.pages[key].numpy(),
                                      np.asarray(pages[key]))
        assert pw.shared_layer_bytes(key) == \
            m.pages_per_layer * m.page_elems * 4


# ------------------------------------------------------------------ engine

LENS = (5, 14, 3, 40, 9, 20, 11)
QUOTAS = (6, 3, 9, 9, 5, 7, 8)
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)
EXPERT = dict(expert_paged=True, page_elems=4096, w_gpu_ratio=0.25)
RUNS = {
    "static": dict(mode="static"),
    "module_static": dict(mode="static", module_batch=True),
    "kv_static": dict(mode="static", kv_paged=True, kv_gpu_ratio=0.25),
    "kv_module_static": dict(mode="static", kv_paged=True,
                             kv_gpu_ratio=0.25, module_batch=True),
    "expert_static": dict(mode="static", **EXPERT),
    "expert_module_static": dict(mode="static", module_batch=True, **EXPERT),
    "expert_predict_static": dict(mode="static", replicate_frac=0.5,
                                  **EXPERT),
    "paged_layer": dict(paged=True, page_elems=4096),
    "paged_layer_static": dict(mode="static", paged=True, page_elems=4096),
    # every micro-batch in the rows of the one rotation group, longest
    # first (Algorithm 2), so later, shorter ones reuse longer ones' rows
    "static_one_group": dict(mode="static", num_ubs=1),
}


def _record(eng, rids):
    return dict(out={r: eng.scheduler.requests[r].generated for r in rids},
                aborted=[eng.scheduler.requests[r].aborted for r in rids],
                weight=eng.weight_traffic(), kv=eng.kv_traffic(),
                tokens_out=eng.tokens_out, steps=eng.steps)


def _prompts(vocab, lens=LENS, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n) for n in lens]


@pytest.fixture(scope="module")
def jax_runs(smoke_params):
    cfg = _mixtral(get_config)
    params = jax.tree.map(jnp.asarray, smoke_params)
    prompts = _prompts(cfg.vocab_size)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, kw in RUNS.items():
            eng = JaxEngine(cfg, params, JaxEngineConfig(
                **{**SLOTS, **kw}, watchdog=False, degrade=False),
                JaxPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
            eng.run_until_idle()
            assert all(r.done for r in eng.scheduler.requests.values())
            runs[name] = _record(eng, rids)
    return dict(prompts=prompts, runs=runs)


def _port(smoke_params, kw, prompts, quotas=QUOTAS, policy=None):
    eng = Engine(_mixtral(t_get_config),
                 params_from_numpy(smoke_params, device="cpu"),
                 EngineConfig(**{**SLOTS, **kw}),
                 policy or ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q) for p, q in zip(prompts, quotas)]
    eng.run_until_idle()
    return eng, _record(eng, rids)


@pytest.mark.parametrize("run", list(RUNS))
def test_static_engine_matches_jax(smoke_params, jax_runs, run):
    kw = RUNS[run]
    eng, got = _port(smoke_params, kw, jax_runs["prompts"])
    assert got == jax_runs["runs"][run]
    assert all(len(v) == q for v, q in zip(got["out"].values(), QUOTAS))
    w, kv = got["weight"], got["kv"]
    if kw.get("mode") == "static":
        # every micro-batch retired and its rotation group free again
        assert eng.active == []
        assert sorted(eng._static_gids) == list(range(eng.ecfg.num_ubs))
    if kw.get("paged"):
        assert w["mode"] == "paged" and w["h2d_bytes"] > 0
        per_pass = sum(eng.paged_blocks.shared_layer_bytes(k)
                       * m.num_layers
                       for k, m in eng.paged_blocks.manifests.items())
        assert w["h2d_bytes"] == per_pass * w["fwd_passes"]
    if kw.get("kv_paged"):
        # the arena (its floor, one micro-batch's 8 blocks) overflows
        assert kv["spills"] > 0
        assert kv["peak_blocks_in_use"] <= kv["device_blocks"]
        eng._kv.check_invariants()
        assert eng._kv.in_use_device() == 0
    if kw.get("expert_paged"):
        assert w["misses"] > 0
        # static mode never prefetches ahead of a group's router
        assert w["prefetches"] == 0 and w["predicted_prefetches"] == 0
    if kw.get("module_batch") and not kw.get("kv_paged"):
        assert w["module_groups"] == 2 and w["module_batch"]


def test_later_shorter_micro_batch_in_reused_rows(smoke_params):
    """One rotation group: the second micro-batch (prompts of 6 and 4)
    prefills and decodes in the rows the first (prompts of 60 and 52, 12
    tokens each: rings written up to position 71) left.  Its transcripts
    equal the JAX engine's, which allocates a fresh cache, and those of a
    port engine that serves the short pair alone in untouched rows."""
    cfg = _mixtral(get_config)
    lens, quotas = (60, 6, 52, 4), (12, 9, 12, 9)
    prompts = _prompts(cfg.vocab_size, lens, seed=9)
    kw = dict(mode="static", num_ubs=1, max_seq=96)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        jeng = JaxEngine(cfg, jax.tree.map(jnp.asarray, smoke_params),
                         JaxEngineConfig(**{**SLOTS, **kw}, watchdog=False,
                                         degrade=False),
                         JaxPolicy(moe_impl="grouped", use_kernels=False))
        rids = [jeng.submit(p, q) for p, q in zip(prompts, quotas)]
        jeng.run_until_idle()
        want = _record(jeng, rids)
    eng, got = _port(smoke_params, kw, prompts, quotas)
    assert got == want
    # one tick a token after each micro-batch's first: the pairs in turn
    assert eng.steps == (12 - 1) + (9 - 1)
    _, alone = _port(smoke_params, kw, prompts[1::2], quotas[1::2])
    assert list(alone["out"].values()) == [got["out"][1], got["out"][3]]


@pytest.mark.parametrize("run", ["module_static", "kv_module_static"])
def test_static_windows_view_or_copy_the_pool_rows(smoke_params, run):
    """A static window whose micro-batches sit in ascending, consecutive
    rotation groups runs on a view of the pool's rows; one whose groups
    came back out of order (a later micro-batch took a freed group)
    concatenates their caches and writes them back.  Both happen on this
    workload, and the windows' transcripts equal lockstep static's."""
    prompts = _prompts(_mixtral(t_get_config).vocab_size)
    eng = Engine(_mixtral(t_get_config),
                 params_from_numpy(smoke_params, device="cpu"),
                 EngineConfig(**{**SLOTS, **RUNS[run]}),
                 ExecPolicy(moe_impl="grouped"), device="cpu")
    calls = {"window": 0, "copy": 0}
    window, concat = eng._decode_window, kvcache.concat_slot_caches

    def counted_window(*args):
        calls["window"] += 1
        return window(*args)

    def counted_concat(caches):
        calls["copy"] += 1
        return concat(caches)
    eng._decode_window = counted_window
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kvcache, "concat_slot_caches", counted_concat)
        rids = [eng.submit(p, q) for p, q in zip(prompts, QUOTAS)]
        eng.run_until_idle()
    lockstep = {k: v for k, v in RUNS[run].items() if k != "module_batch"}
    _, want = _port(smoke_params, lockstep, prompts)
    assert _record(eng, rids)["out"] == want["out"]
    assert 0 < calls["copy"] < calls["window"]


@pytest.mark.parametrize("layout", [
    {}, dict(module_batch=True), dict(kv_paged=True, kv_gpu_ratio=0.25),
    dict(kv_paged=True, kv_gpu_ratio=0.25, module_batch=True), EXPERT,
    dict(paged=True, page_elems=4096)],
    ids=["dense", "module", "kv", "kv_module", "expert", "paged_layer"])
def test_static_equals_continuous_in_the_port(smoke_params, layout):
    """With the dense MoE every token's FFN is independent of the batch it
    shares, so static mode (μ rows prefilled at once, one token a tick)
    gives continuous mode's greedy transcripts."""
    prompts = _prompts(_mixtral(t_get_config).vocab_size)
    _, cont = _port(smoke_params, layout, prompts, policy=ExecPolicy())
    _, stat = _port(smoke_params, dict(layout, mode="static"), prompts,
                    policy=ExecPolicy())
    assert stat["out"] == cont["out"]
    assert stat["steps"] > cont["steps"]


def test_static_admission_books_against_block_arena():
    """The port's ``test_engine_continuous.py::
    test_static_admission_books_against_block_arena``: with the paged pool,
    every static admission books its rows' blocks against the shared arena,
    so a deep queue never allocates device KV beyond it, and drained
    batches give every block back; its transcripts and ``kv_traffic()``
    equal the JAX engine's."""
    cfg = _qwen(get_config)
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.key(3)))
    kw = dict(ubatch=2, num_ubs=2, max_seq=64, mode="static", kv_paged=True,
              kv_gpu_ratio=0.5)
    rng = np.random.default_rng(7)
    work = [(rng.integers(2, cfg.vocab_size, int(rng.integers(3, 30))),
             int(rng.integers(1, 8))) for _ in range(11)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        jeng = JaxEngine(cfg, jax.tree.map(jnp.asarray, params),
                         JaxEngineConfig(**kw, watchdog=False,
                                         degrade=False))
        rids = [jeng.submit(p, q) for p, q in work]
        jeng.run_until_idle()
        want = _record(jeng, rids)
    eng = Engine(_qwen(t_get_config), params_from_numpy(params, device="cpu"),
                 EngineConfig(**kw), device="cpu")
    rids = [eng.submit(p, q) for p, q in work]
    out = eng.run_until_idle()
    assert _record(eng, rids) == want
    assert all(r.done for r in eng.scheduler.requests.values())
    assert sum(len(v) for v in out.values()) > 0
    # arena invariant: occupancy peaked at or below the device arena, and
    # every block was released when its micro-batch retired
    assert eng._kv.peak_in_use <= eng._kv.device_blocks
    assert eng._kv.in_use_device() == 0
    eng._kv.check_invariants()
    # and the whole pool honors the r_c sizing (micro-batch floor aside)
    total = 2 * 2 * (64 // eng.ecfg.block_tokens)
    assert eng._kv.device_blocks == max(2 * (64 // eng.ecfg.block_tokens),
                                        round(0.5 * total))


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_whole_layer_stream_cuda_matches_resident(cuda_device, mode):
    """bf16 through the kernels, mixtral at its served width with 2
    layers: the whole-layer paged engine reads every layer from
    page-locked stores (no pageable store) through the two-slot buffer,
    and its greedy transcripts equal the resident engine's bit for bit
    (the same kernels read the same bytes); its booked bytes are the
    page-padded layers times the forward passes."""
    from repro_torch.models.params import init_params as t_init_params
    cfg = dataclasses.replace(t_get_config("mixtral-8x7b"), num_layers=2)
    params = t_init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, n)
               for n in (5, 30, 17, 60, 9, 44)]
    runs = []
    for paged in (False, True):
        eng = Engine(cfg, params,
                     EngineConfig(ubatch=2, num_ubs=2, max_seq=128,
                                  decode_chunk=4, mode=mode, paged=paged),
                     ExecPolicy(moe_impl="grouped", use_kernels=True),
                     device=cuda_device)
        try:
            if paged:
                assert all(t.is_pinned()
                           for t in eng.paged_blocks.pages.values())
            rids = [eng.submit(p, 8) for p in prompts]
            out = eng.run_until_idle()
            runs.append([out[r] for r in rids])
            w = eng.weight_traffic()
            if paged:
                assert w["mode"] == "paged"
                assert w["h2d_bytes"] == w["fwd_passes"] * sum(
                    t.nbytes for t in eng.paged_blocks.pages.values())
        finally:
            if eng.paged_blocks is not None:
                eng.paged_blocks.release()
    assert runs[0] == runs[1]
