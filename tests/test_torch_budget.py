"""The port's EOS-aware reservations and budget preemption against the JAX
package's.

  * ``GenLenEWMA``: seeded streams of observed generation lengths give the
    same value, count and expectations.
  * ``Scheduler``: one seeded sequence of events (submit, admit, decode,
    finish, ``enforce_budget``) driven through both schedulers, in both
    reservation modes, dense and block-charged: the same admissions,
    preemptions, queue order and slot states after every event.
  * Engine: greedy transcripts, per-request preemptions, slot histories and
    ``kv_traffic()`` equal the JAX engine's in the EWMA regimes of
    ``test_engine_fuzz.py`` (``ewma_tight`` and ``overlap_ewma`` on the
    qwen2.5 smoke, EWMA over the paged arena at r_c 0.25) and on the
    workload of ``test_kv_paging.py``'s budget-preemption test (mixtral
    smoke, r_c 0.3, ``cache_tokens`` 64, no fault plan), whose JAX run
    must preempt before anything is compared.

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
from repro.core.batching import GenLenEWMA as JaxGenLenEWMA  # noqa: E402
from repro.models.model import ExecPolicy as JaxPolicy  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.batching import GenLenEWMA  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Scheduler, SlotState  # noqa: E402


# ---------------------------------------------------------------- GenLenEWMA

@pytest.mark.parametrize("alpha,seed", [(0.25, 0), (0.5, 1), (1.0, 2),
                                        (0.1, 3)])
def test_gen_len_ewma_matches_jax(alpha, seed):
    rng = np.random.default_rng(seed)
    a, b = GenLenEWMA(alpha), JaxGenLenEWMA(alpha)
    quotas = (1, 3, 8, 32)
    assert [a.expected(q) for q in quotas] == [b.expected(q) for q in quotas]
    for n in rng.integers(0, 40, 50):
        a.observe(int(n))
        b.observe(int(n))
        assert (a.value, a.count) == (b.value, b.count)
        assert [a.expected(q) for q in quotas] == \
            [b.expected(q) for q in quotas]


# ----------------------------------------------------------------- Scheduler

def _state(s):
    return dict(
        queue=[r.rid for r in s.queue],
        slots=[(sl.state.value if sl.state.value != "drained" else "free",
                sl.req.rid if sl.req else None, list(sl.history),
                sl.prefill_pos) for grp in s.slots for sl in grp],
        reqs={rid: (r.done, r.aborted, r.preemptions, list(r.generated))
              for rid, r in s.requests.items()},
        loads=[s.group_load(g) for g in range(s.num_ubs)],
        ewma=(s.gen_ewma.value, s.gen_ewma.count))


@pytest.mark.parametrize("mode", ["worst", "ewma"])
@pytest.mark.parametrize("block_tokens", [None, 8])
@pytest.mark.parametrize("seed", [1, 2, 4])
def test_scheduler_event_trace_matches_jax(mode, block_tokens, seed):
    """Both schedulers through one seeded event sequence.  The per-group
    budget is tight (3 slots, 48 tokens) and a third of the rows stop early
    (EOS), so that admission waits and, under EWMA reservations,
    ``enforce_budget`` preempts.  The last seed runs the EWMA at another
    step (``ewma_alpha``)."""
    ub, nub, max_seq, budget, chunk = 3, 2, 48, 48, 4
    alpha = 0.25 if seed < 4 else 0.5
    port = Scheduler(ubatch=ub, num_ubs=nub, cache_tokens=budget,
                     gen_len=32, max_input_len=max_seq, reserve_mode=mode,
                     ewma_alpha=alpha, block_tokens=block_tokens)
    ref = JaxScheduler(ubatch=ub, num_ubs=nub, cache_tokens=budget,
                       gen_len=32, max_input_len=max_seq, reserve_mode=mode,
                       ewma_alpha=alpha, block_tokens=block_tokens)
    rng = np.random.default_rng(seed)
    preempted = 0
    for _ in range(120):
        ev = rng.integers(0, 4)
        if ev == 0:                                          # submit
            n = int(rng.integers(1, 20))
            q = int(rng.integers(1, 28))
            prompt = rng.integers(2, 100, n)
            assert port.submit(prompt, q) == ref.submit(prompt, q)
        elif ev == 1:                                        # admit
            got = [(s.gid, s.row, s.req.rid) for s in port.admit_to_slots()]
            want = [(s.gid, s.row, s.req.rid) for s in ref.admit_to_slots()]
            assert got == want
            for sched in (port, ref):
                for grp in sched.slots:
                    for s in grp:
                        if s.state.value == "prefilling":
                            s.req.generated.append(1)
                            sched.start_decode(s)
        elif ev == 2:                                        # decode + finish
            gid = int(rng.integers(0, nub))
            got = [r.rid for r in port.enforce_budget(gid, chunk)]
            want = [r.rid for r in ref.enforce_budget(gid, chunk)]
            assert got == want
            preempted += len(got)
            for row in range(ub):
                k = int(rng.integers(1, chunk + 1))
                eos = rng.random() < 0.35
                for sched in (port, ref):
                    s = sched.slots[gid][row]
                    if s.state.value != "decoding":
                        continue
                    n = min(k, s.req.remaining)
                    s.req.generated.extend([7] * n)
                    if eos or s.req.remaining == 0:
                        sched.finish(s)
        else:                                                # budget only
            gid = int(rng.integers(0, nub))
            got = [r.rid for r in port.enforce_budget(gid, chunk)]
            want = [r.rid for r in ref.enforce_budget(gid, chunk)]
            assert got == want
            preempted += len(got)
        assert _state(port) == _state(ref)
    # worst-case reservations never overrun; EWMA ones do, and preempt
    assert (preempted > 0) == (mode == "ewma")
    assert any(r.done for r in port.requests.values())


def test_scheduler_ewma_budget_preempts_youngest():
    """A hand-built overrun: three requests admitted on an estimate of one
    token overrun the budget by their next chunk, so the youngest is
    preempted, re-queued and its slot freed."""
    ub, chunk = 3, 4
    sched = Scheduler(ubatch=ub, num_ubs=1, cache_tokens=40, gen_len=32,
                      max_input_len=32, reserve_mode="ewma")
    sched.gen_ewma.observe(1)                # optimistic: expect 1 token
    for _ in range(3):
        sched.submit(np.arange(2, 12), 12)
    slots = sched.admit_to_slots()
    assert len(slots) == 3
    for s in slots:
        s.req.generated.append(1)
        sched.start_decode(s)
    pre = sched.enforce_budget(0, chunk)
    assert [r.rid for r in pre] == [2]
    assert sched.requests[2].preemptions == 1
    assert [r.rid for r in sched.queue] == [2]
    assert sched.slots[0][2].state is SlotState.FREE


# -------------------------------------------------------------------- engine

def _qwen(get):
    return dataclasses.replace(get("qwen2.5-3b").smoke(), dtype="float32")


def _mixtral(get):
    return dataclasses.replace(get("mixtral-8x7b").smoke(), dtype="float32")


def _fuzz_work(vocab, seed, n=8, max_len=40, max_quota=10):
    """``test_engine_fuzz._workload``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, int(rng.integers(1, max_len))),
             int(rng.integers(1, max_quota))) for _ in range(n)]


def _skewed_work(vocab, seed=11, n=8):
    """``test_kv_paging._skewed_work`` with every quota + 8."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, int(rng.integers(4, 20))),
             (4 if i % 2 == 0 else 12) + 8) for i in range(n)]


FUZZ = dict(ubatch=3, num_ubs=2, max_seq=64)
TIGHT = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)
RUNS = {
    # (model, workload seed, engine settings)
    "ewma_tight": ("qwen", 1, dict(FUZZ, reserve_mode="ewma",
                                   cache_tokens=100, decode_chunk=4)),
    "ewma_tight_s3": ("qwen", 3, dict(FUZZ, reserve_mode="ewma",
                                      cache_tokens=100, decode_chunk=4)),
    "overlap_ewma": ("qwen", 2, dict(FUZZ, overlap=True, prefill_chunk=8,
                                     decode_chunk=4, reserve_mode="ewma",
                                     cache_tokens=100)),
    "ewma_kv_rc025": ("qwen", 1, dict(FUZZ, reserve_mode="ewma",
                                      cache_tokens=100, decode_chunk=4,
                                      kv_paged=True, kv_gpu_ratio=0.25)),
    "budget_preempt": ("mixtral", 11, dict(TIGHT, kv_paged=True,
                                           kv_gpu_ratio=0.3,
                                           reserve_mode="ewma",
                                           cache_tokens=64)),
}


def _work(model, vocab, seed):
    if model == "mixtral":
        return _skewed_work(vocab, seed)
    return _fuzz_work(vocab, seed)


def _record(eng, rids):
    slots = [s for grp in eng.scheduler.slots for s in grp]
    return dict(
        out={r: eng.scheduler.requests[r].generated for r in rids},
        preemptions=[eng.scheduler.requests[r].preemptions for r in rids],
        histories=[s.history for s in slots],
        kv=eng.kv_traffic(), tokens_out=eng.tokens_out)


@pytest.fixture(scope="module")
def jax_runs():
    models = {"qwen": (_qwen(get_config), jax.random.key(3)),
              "mixtral": (_mixtral(get_config), jax.random.key(1))}
    params = {k: init_params(cfg, key) for k, (cfg, key) in models.items()}
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "pinned_host_sharding", lambda **kw: None)
        for name, (model, seed, kw) in RUNS.items():
            cfg = models[model][0]
            eng = JaxEngine(cfg, params[model], JaxEngineConfig(
                **kw, watchdog=False, degrade=False),
                JaxPolicy(moe_impl="grouped", use_kernels=False))
            rids = [eng.submit(p, q)
                    for p, q in _work(model, cfg.vocab_size, seed)]
            eng.run_until_idle()
            assert all(r.done for r in eng.scheduler.requests.values())
            runs[name] = _record(eng, rids)
    return dict(params={k: jax.tree.map(np.asarray, v)
                        for k, v in params.items()}, runs=runs)


@pytest.mark.parametrize("run", list(RUNS))
def test_budget_engine_matches_jax(jax_runs, run):
    model, seed, kw = RUNS[run]
    want = jax_runs["runs"][run]
    if run == "budget_preempt":
        assert sum(want["preemptions"]) > 0, \
            "the reference never preempted: nothing to compare"
    cfg = (_mixtral if model == "mixtral" else _qwen)(t_get_config)
    eng = Engine(cfg, params_from_numpy(jax_runs["params"][model],
                                        device="cpu"),
                 EngineConfig(**kw), ExecPolicy(moe_impl="grouped"),
                 device="cpu")
    work = _work(model, cfg.vocab_size, seed)
    rids = [eng.submit(p, q) for p, q in work]
    eng.run_until_idle()
    got = _record(eng, rids)
    assert got == want
    assert all(len(got["out"][r]) == q or got["out"][r][-1] == kw.get(
        "eos_id", 1) for r, (_, q) in zip(rids, work))
    assert all(s.state is SlotState.FREE
               for grp in eng.scheduler.slots for s in grp)
    assert eng.scheduler.gen_ewma.count == len(work)
    if eng._kv is not None:
        eng._kv.check_invariants()
        assert eng._kv.in_use_device() == 0
