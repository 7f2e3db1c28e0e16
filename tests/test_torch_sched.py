"""The port's batch admission and request handling against the JAX
package's.

  * ``batch_requests`` (Algorithm 2) on seeded queues: the same
    micro-batches, in the same order, and the same deferred requests, with
    the invariants of ``tests/test_batching.py`` (conservation, the size
    cap, the cache budget, balance).
  * ``Scheduler.admit`` over seeded submit / admit / retire sequences:
    the same micro-batches, queue and permanent aborts (a request that
    cannot fit an empty partition under the uniform ``gen_len``).
  * ``on_long_prompt``: rejection and truncation in the scheduler, and
    through the engine (the port's mirror of ``test_engine_continuous.py``'s
    long-prompt tests, against the JAX engine's transcripts).
  * Seeded scheduler traces: a copy of ``tests/scheduler_trace.py``'s
    driver (staged prefill, ``enforce_budget`` before every group's chunk,
    EOS, recompute preemption) runs both packages' ``Scheduler`` and
    checks the lifecycle invariants after every tick; served, aborted,
    preemptions, ticks and the peak group footprint are equal.  Shedding
    is held in ``tests/test_torch_faults.py``.  The port's guard is given
    the prefill chunk and also charges the first token of a staged
    prefill that its next chunk completes; on the repro where the JAX
    package's guard ends one token over budget, the port's holds it.
"""
import dataclasses
from dataclasses import dataclass, field
from typing import List

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.batching import Request as JaxRequest  # noqa: E402
from repro.core.batching import batch_requests as jax_batch  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.batching import Request, batch_requests  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

# ------------------------------------------------------------ Algorithm 2


def _queue(rng, n):
    return [(i, int(rng.integers(1, 500)), int(rng.integers(1, 64)))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(12))
def test_batch_requests_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        q = _queue(rng, int(rng.integers(0, 60)))
        n_ub, ubs = int(rng.integers(1, 9)), int(rng.integers(1, 17))
        gen_len = int(rng.integers(1, 65))
        cache = int(rng.integers(64, 4097))
        mbs, aborted = batch_requests([Request(*r) for r in q], n_ub, ubs,
                                      gen_len, cache)
        jmbs, jaborted = jax_batch([JaxRequest(*r) for r in q], n_ub, ubs,
                                   gen_len, cache)
        assert [[dataclasses.astuple(r) for r in mb.requests]
                for mb in mbs] == \
            [[dataclasses.astuple(r) for r in mb.requests] for mb in jmbs]
        assert [dataclasses.astuple(r) for r in aborted] == \
            [dataclasses.astuple(r) for r in jaborted]
        assert [mb.tokens for mb in mbs] == [mb.tokens for mb in jmbs]
        # test_batching.py's invariants
        placed = [r.rid for mb in mbs for r in mb.requests]
        assert sorted(placed + [r.rid for r in aborted]) == \
            [r[0] for r in q]
        for mb in mbs:
            assert len(mb) <= ubs
            assert mb.tokens + len(mb) * gen_len <= cache
        for r in aborted:
            assert r.input_len + gen_len > cache or len(mbs) >= 1


def test_batch_requests_balances_longest_first():
    rng = np.random.default_rng(3)
    reqs = [Request(i, int(rng.integers(1, 500))) for i in range(40)]
    mbs, _ = batch_requests(reqs, 4, 1000, 1, 10 ** 9)
    sums = sorted(mb.tokens for mb in mbs)
    assert sums[-1] - sums[0] <= max(r.input_len for r in reqs)


# ---------------------------------------------------------- batch admission

def _sched_pair(**kw):
    return Scheduler(**kw), JaxScheduler(**kw)


def _state(s):
    return dict(queue=[r.rid for r in s.queue],
                reqs={rid: (r.done, r.aborted, r.input_len,
                            list(r.generated))
                      for rid, r in s.requests.items()})


@pytest.mark.parametrize("seed", range(6))
def test_admit_matches_jax(seed):
    """Submit, admit (capped by the free rotation groups, as the static
    engine calls it) and retire in a seeded order; some prompts are too
    long for an empty partition under gen_len and abort for good."""
    rng = np.random.default_rng(seed)
    nub = int(rng.integers(1, 4))
    kw = dict(ubatch=int(rng.integers(1, 5)), num_ubs=nub,
              cache_tokens=int(rng.integers(40, 120)),
              gen_len=int(rng.integers(4, 40)),
              max_input_len=(None if seed % 2 else
                             int(rng.integers(100, 200))))
    port, ref = _sched_pair(**kw)
    active: List[List[int]] = []
    rejected = set()                 # at submit: prompt + quota too long
    for _ in range(60):
        ev = rng.integers(0, 3)
        if ev == 0:
            n = int(rng.integers(1, 100))
            q = int(rng.integers(1, 30))
            prompt = rng.integers(2, 100, n)
            rid = port.submit(prompt, q)
            assert rid == ref.submit(prompt, q)
            if port.requests[rid].aborted:
                rejected.add(rid)
        elif ev == 1:
            cap = nub - len(active)
            got = [[r.rid for r in g] for g in port.admit(cap)]
            want = [[r.rid for r in g] for g in ref.admit(cap)]
            assert got == want
            assert len(got) <= max(cap, 0)
            active += got
        elif active:
            # a micro-batch retires: its requests are done
            for s in (port, ref):
                for rid in active[0]:
                    s.requests[rid].done = True
            active.pop(0)
        assert _state(port) == _state(ref)
    assert any(r.aborted and rid not in rejected
               for rid, r in port.requests.items())


def test_admit_aborts_never_fitting_request():
    """``test_engine_continuous.py::
    test_static_admit_also_aborts_never_fitting_request`` on the port."""
    for s in _sched_pair(ubatch=2, num_ubs=1, cache_tokens=40, gen_len=32,
                         max_input_len=None):
        rid_bad = s.submit(np.arange(20, dtype=np.int32), 4)    # 20+32 > 40
        rid_ok = s.submit(np.arange(4, dtype=np.int32), 4)      # 4+32 <= 40
        groups = s.admit()
        assert [[r.rid for r in g] for g in groups] == [[rid_ok]]
        assert s.requests[rid_bad].aborted and s.requests[rid_bad].done
        assert s.queue == []


# ------------------------------------------------------ long prompts

@pytest.mark.parametrize("policy", ["reject", "truncate"])
def test_submit_long_prompt_matches_jax(policy):
    rng = np.random.default_rng(8)
    port, ref = _sched_pair(ubatch=2, num_ubs=1, cache_tokens=64,
                            gen_len=8, max_input_len=32,
                            on_long_prompt=policy)
    for n, q in ((100, 4), (30, 8), (8, 4), (32, 1), (31, 1), (40, 32),
                 (40, 31)):
        prompt = rng.integers(2, 50, n)
        assert port.submit(prompt, q) == ref.submit(prompt, q)
    assert _state(port) == _state(ref)
    got = {rid: (r.aborted, r.input_len) for rid, r in port.requests.items()}
    if policy == "reject":
        want = [(True, 100), (True, 30), (False, 8), (True, 32), (False, 31),
                (True, 40), (True, 40)]
    else:
        # trimmed so that prompt + generation fits the ring; a quota that
        # leaves no prompt token is rejected
        want = [(False, 28), (False, 24), (False, 8), (False, 31),
                (False, 31), (True, 40), (False, 1)]
    assert [got[i] for i in range(7)] == want


@pytest.fixture(scope="module")
def qwen_params():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").smoke(),
                              dtype="float32")
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.key(3)))


@pytest.mark.parametrize("mode", ["continuous", "static"])
@pytest.mark.parametrize("policy", ["reject", "truncate"])
def test_engine_long_prompt_matches_jax(qwen_params, policy, mode):
    """The engine rejects (``aborted``, no tokens) or truncates a prompt
    whose prompt + quota exceeds ``max_seq``, never crashing, and serves
    the rest: transcripts and prompt lengths equal the JAX engine's."""
    kw = dict(ubatch=2, num_ubs=1, max_seq=32, on_long_prompt=policy,
              mode=mode)
    rng = np.random.default_rng(4)
    work = [(rng.integers(2, 256, 100), 4), (rng.integers(2, 256, 30), 8),
            (rng.integers(2, 256, 8), 4)]
    cfg = dataclasses.replace(get_config("qwen2.5-3b").smoke(),
                              dtype="float32")
    jeng = JaxEngine(cfg, jax.tree.map(jax.numpy.asarray, qwen_params),
                     JaxEngineConfig(**kw, watchdog=False, degrade=False))
    eng = Engine(dataclasses.replace(t_get_config("qwen2.5-3b").smoke(),
                                     dtype="float32"),
                 params_from_numpy(qwen_params, device="cpu"),
                 EngineConfig(**kw), device="cpu")
    res = []
    for e in (eng, jeng):
        rids = [e.submit(p, q) for p, q in work]
        out = e.run_until_idle()
        res.append([(out[r], e.scheduler.requests[r].aborted,
                     e.scheduler.requests[r].input_len) for r in rids])
    assert res[0] == res[1]
    (bad, wrap, ok) = res[0]
    assert len(ok[0]) == 4 and not ok[1]
    if policy == "reject":
        assert bad == ([], True, 100) and wrap == ([], True, 30)
    else:
        assert bad[1:] == (False, 32 - 4) and len(bad[0]) == 4
        assert wrap[1:] == (False, 32 - 8) and len(wrap[0]) == 8


# ------------------------------------------------------ scheduler traces

@dataclass
class TraceResult:
    served: List[int] = field(default_factory=list)     # rids finished
    aborted: List[int] = field(default_factory=list)
    preemptions: int = 0
    ticks: int = 0
    max_group_footprint: int = 0


def _is(state, *names):
    return state.value in names


def _check_invariants(sched, res: TraceResult) -> None:
    live_rids = []
    for gid in range(sched.num_ubs):
        occ = 0
        for s in sched.slots[gid]:
            if not _is(s.state, "prefilling", "decoding"):
                continue
            assert s.req is not None, "live slot without a request"
            live_rids.append(s.req.rid)
            assert not s.req.done and not s.req.aborted
            occ += s.req.footprint
        assert occ <= sched.cache_tokens, \
            f"group {gid} footprint {occ} > budget {sched.cache_tokens}"
        res.max_group_footprint = max(res.max_group_footprint, occ)
    assert len(live_rids) == len(set(live_rids)), "request in two slots"
    queued = [r.rid for r in sched.queue]
    assert len(queued) == len(set(queued)), "request queued twice"
    assert not set(queued) & set(live_rids), "request queued while live"
    for grp in sched.slots:
        for s in grp:
            if _is(s.state, "free"):
                assert s.req is None


def _run_trace(sched, *, requests, arrivals, chunk, prefill_chunk,
               eos_draw, max_ticks=2000) -> TraceResult:
    """``tests/scheduler_trace.run_trace`` without shed, for either
    package's Scheduler (the port has no DRAINED state: its slots go from
    DECODE straight back to FREE)."""
    res = TraceResult()
    pending = sorted(range(len(requests)), key=lambda i: arrivals[i])
    rid_of = {}

    def finish(slot):
        res.served.append(slot.req.rid)
        sched.finish(slot)

    for tick in range(max_ticks):
        res.ticks = tick
        while pending and arrivals[pending[0]] <= tick:
            i = pending.pop(0)
            n, q = requests[i]
            rid_of[i] = sched.submit(list(range(2, 2 + n)), q)
        queue_before = [r.rid for r in sched.queue]
        admitted = sched.admit_to_slots()
        placeable = [rid for rid in queue_before
                     if not sched.requests[rid].aborted]
        assert [s.req.rid for s in admitted] == \
            placeable[:len(admitted)], "admission skipped the queue head"
        for grp in sched.slots:
            for s in grp:
                if not _is(s.state, "prefilling"):
                    continue
                target = s.req.footprint
                sched.prefill_progress(
                    s, min(prefill_chunk, target - s.prefill_pos))
                if s.prefill_pos >= target:
                    s.req.generated.append(0)
                    if len(s.req.generated) >= s.req.max_new_tokens or \
                            eos_draw(s.req.rid, len(s.req.generated)):
                        finish(s)
                    else:
                        sched.start_decode(s)
        _check_invariants(sched, res)
        for gid in range(sched.num_ubs):
            # the port's guard also charges a staged prefill's first token
            # (ROADMAP's deliberate deviations); the JAX package's takes
            # no prefill chunk
            preempted = (sched.enforce_budget(gid, chunk, prefill_chunk)
                         if isinstance(sched, Scheduler)
                         else sched.enforce_budget(gid, chunk))
            res.preemptions += len(preempted)
            if sched.reserve_mode == "worst":
                assert not preempted
            for s in list(sched.slots[gid]):
                if not _is(s.state, "decoding"):
                    continue
                for _ in range(min(chunk, s.req.remaining)):
                    s.req.generated.append(0)
                    if eos_draw(s.req.rid, len(s.req.generated)):
                        break
                if s.req.remaining == 0 or \
                        eos_draw(s.req.rid, len(s.req.generated)):
                    finish(s)
            _check_invariants(sched, res)
        if not pending and not sched.queue and not sched.has_live_slots():
            break
    else:
        raise AssertionError("trace did not drain (livelock?)")
    res.aborted = [r.rid for r in sched.requests.values() if r.aborted]
    assert sorted(res.served + res.aborted) == sorted(rid_of.values())
    for r in sched.requests.values():
        assert r.done
        if not r.aborted:
            assert 1 <= len(r.generated) <= r.max_new_tokens
    return res


def _eos_none(rid, k):
    return False


def _eos_hash(salt, mod):
    def draw(rid, k):
        return (rid * 2654435761 + k * 40503 + salt) % mod == 0
    return draw


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("reserve_mode", ["worst", "ewma"])
def test_scheduler_traces_match_jax(seed, reserve_mode):
    """``test_scheduler_traces.py::test_random_traces_uphold_invariants``
    through both packages' schedulers: equal results, invariants held."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 20))
    requests = [(int(rng.integers(1, 24)), int(rng.integers(1, 12)))
                for _ in range(n)]
    arrivals = sorted(int(rng.integers(0, 10)) for _ in range(n))
    kw = dict(ubatch=int(rng.integers(1, 4)),
              num_ubs=int(rng.integers(1, 4)),
              cache_tokens=int(rng.integers(8, 64)), gen_len=8,
              max_input_len=None, reserve_mode=reserve_mode)
    drive = dict(requests=requests, arrivals=arrivals,
                 chunk=int(rng.integers(1, 8)),
                 prefill_chunk=int(rng.integers(1, 8)),
                 eos_draw=_eos_hash(seed, 5) if seed % 2 else _eos_none)
    got = _run_trace(Scheduler(**kw), **drive)
    want = _run_trace(JaxScheduler(**kw), **drive)
    assert got == want
    assert len(got.served) + len(got.aborted) == n


def test_budget_guard_charges_a_completing_prefill():
    """The repro that Hypothesis found in
    ``test_scheduler_props.py::test_ewma_reservations_hold_invariants``:
    two slots, a budget of 8, chunks of 1 token, no EOS.  The JAX
    package's guard charges a staged prefill its footprint alone, so the
    first token that its last prefill chunk emits lands before the next
    guard and the group reaches 9 on tick 3 (the documented deviation,
    asserted here).  The port's guard charges that token too and holds
    the group within 8 at every tick."""
    kw = dict(ubatch=2, num_ubs=1, cache_tokens=8, gen_len=8,
              max_input_len=None, reserve_mode="ewma")
    drive = dict(requests=[(1, 1), (1, 5), (3, 2)], arrivals=[0, 0, 0],
                 chunk=1, prefill_chunk=1, eos_draw=_eos_none)
    got = _run_trace(Scheduler(**kw), **drive)
    assert got.max_group_footprint <= 8
    assert sorted(got.served) == [0, 1, 2] and got.preemptions >= 1
    with pytest.raises(AssertionError, match="footprint 9 > budget 8"):
        _run_trace(JaxScheduler(**kw), **drive)
