"""The port's engine with both offload ratios at once (expert-granular paged
weights at r_w 0.25 and the block-paged KV arena at r_c 0.25) against the
JAX engine in the same configuration.

Mixtral smoke in float32, weights from ``jax.random.key(4)``, the workload
of ``test_engine_fuzz.py::test_kv_paged_with_expert_paged`` (seed 3): greedy
transcripts, per-request preemptions, slot histories, ``kv_traffic()`` and
``weight_traffic()`` equal the JAX engine's exactly in lockstep, in windows,
in windows under EWMA reservations with a tight ``cache_tokens``, and with
overlapped admission (which holds about two requests in the arena at a
time, so it does not spill on this workload).  Each port run is held to
the JAX run of its own configuration, never to another mode's transcripts
(a preemption changes who shares a capacity bucket).  In lockstep, expert
paging leaves the KV plan as it was: ``kv_traffic()`` equals the KV-only
run's.

The JAX engines run with their watchdog and degradation ladder off and are
built once per module, with ``offload.pinned_host_sharding`` patched to
None from here (as in ``test_torch_paged.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import SlotState  # noqa: E402

SLOTS = dict(ubatch=3, num_ubs=2, max_seq=64, decode_chunk=4)
BOTH = dict(expert_paged=True, page_elems=4096, w_gpu_ratio=0.25,
            kv_paged=True, kv_gpu_ratio=0.25)
RUNS = {
    "kv_only": dict(kv_paged=True, kv_gpu_ratio=0.25),
    "lockstep": dict(BOTH),
    "windows": dict(BOTH, module_batch=True),
    "windows_ewma": dict(BOTH, module_batch=True, reserve_mode="ewma",
                         cache_tokens=64),
    "overlap": dict(BOTH, overlap=True, prefill_chunk=8),
}


def _smoke(get):
    return dataclasses.replace(get("mixtral-8x7b").smoke(), dtype="float32")


def _workload(vocab):
    """``test_engine_fuzz._workload(cfg, seed=3, n_requests=6, max_len=24,
    max_quota=8)``."""
    rng = np.random.default_rng(3)
    return [(rng.integers(2, vocab, int(rng.integers(1, 24))),
             int(rng.integers(1, 8))) for _ in range(6)]


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(
        out={r: eng.scheduler.requests[r].generated for r in rids},
        preemptions=[eng.scheduler.requests[r].preemptions for r in rids],
        histories=[s.history for s in slots],
        kv=eng.kv_traffic(), weight=eng.weight_traffic(),
        tokens_out=eng.tokens_out)


@pytest.fixture(scope="module")
def jax_runs():
    cfg = _smoke(get_config)
    params = init_params(cfg, jax.random.key(4))
    work = _workload(cfg.vocab_size)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, kw in RUNS.items():
            eng = JaxEngine(cfg, params, JaxEngineConfig(
                **SLOTS, **kw, watchdog=False, degrade=False),
                JaxPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q) for p, q in work]
            eng.run_until_idle()
            runs[name] = _record(eng, rids)
    return dict(params=jax.tree.map(np.asarray, params), work=work,
                runs=runs)


def _port_run(jax_runs, run):
    eng = Engine(_smoke(t_get_config),
                 params_from_numpy(jax_runs["params"], device="cpu"),
                 EngineConfig(**SLOTS, **RUNS[run]),
                 ExecPolicy(moe_impl="grouped"), device="cpu")
    rids = [eng.submit(p, q) for p, q in jax_runs["work"]]
    eng.run_until_idle()
    return eng, _record(eng, rids)


@pytest.mark.parametrize("run", list(RUNS))
def test_pair_engine_matches_jax(jax_runs, run):
    eng, got = _port_run(jax_runs, run)
    want = jax_runs["runs"][run]
    assert got["out"] == want["out"]
    assert got["preemptions"] == want["preemptions"]
    assert got["histories"] == want["histories"]
    assert got["kv"] == want["kv"]
    assert got["weight"] == want["weight"]
    assert got["tokens_out"] == want["tokens_out"]
    assert all(len(got["out"][r]) == q
               for r, (_, q) in zip(got["out"], jax_runs["work"]))
    assert all(s.state is SlotState.FREE
               for grp in eng.scheduler.slots for s in grp)
    eng._kv.check_invariants()
    kv, w = got["kv"], got["weight"]
    assert kv["mode"] == "kv_paged"
    if run == "overlap":
        # one prefill chunk a tick keeps the arena below its size here
        assert kv["spills"] == 0
    else:
        assert kv["spills"] > 0 and kv["misses"] > 0
    if run == "kv_only":
        assert w["mode"] == "resident"
        return
    assert w["mode"] == "expert_paged"
    assert w["misses"] > 0 and w["h2d_bytes"] > 0
    if run.startswith("windows"):
        assert w["module_batch"] and w["module_groups"] == 2
    for r in eng.residency.values():
        assert r.occupancy() <= r.capacity and not r.pinned


def test_pair_lockstep_kv_plan_equals_kv_only(jax_runs):
    """Expert paging does not touch the KV plan in lockstep: the pair's
    ``kv_traffic()`` equals the KV-only run's, in both packages."""
    _, got = _port_run(jax_runs, "lockstep")
    _, kv_only = _port_run(jax_runs, "kv_only")
    want = jax_runs["runs"]
    assert want["lockstep"]["kv"] == want["kv_only"]["kv"]
    assert got["kv"] == kv_only["kv"]


def test_pair_windows_ewma_preempts(jax_runs):
    """The tight budget under EWMA reservations preempts in the window
    regime, in the JAX run and so in the port's."""
    assert sum(jax_runs["runs"]["windows_ewma"]["preemptions"]) > 0
