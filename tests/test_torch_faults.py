"""The port's fault plane (``repro_torch.runtime``) against the JAX
package's (``repro.runtime``): the unit suite of ``tests/test_faults.py``,
each test body run over both packages' classes, plus cross-package draws.

  * ``FaultPlan`` determinism and scripted traces, the ``FaultInjector``,
    the ``TransferEngine``'s retry / backoff / abort / stall accounting,
    the ``Watchdog``'s EWMA and the ``DegradationLadder``'s hysteresis:
    the reference's 26 unit tests, parametrized over both packages.
  * For the same ``(seed, probs, trace, max_faults)`` the two packages'
    plans draw the same kinds over 200 ops at several interleaved sites
    (one shared generator, one draw per op at a site with a spec), and two
    ``TransferEngine``s over those plans book the same counters — the
    engine parity of ``tests/test_torch_chaos.py`` rests on this.
  * The port's ``BlockPool`` ``kv_pool`` site and ``offload.host_store``'s
    ``host_alloc`` site.
  * The scheduler's degraded-mode shedding: the reference's four shed
    tests on the port's ``Scheduler``, each with the JAX ``Scheduler``'s
    trace beside it.

The runtime modules need no JAX; the JAX side is the reference.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.runtime.faults as jax_faults  # noqa: E402
import repro.runtime.transfer as jax_transfer  # noqa: E402
import repro.runtime.watchdog as jax_watchdog  # noqa: E402
import repro_torch.runtime.faults as t_faults  # noqa: E402
import repro_torch.runtime.transfer as t_transfer  # noqa: E402
import repro_torch.runtime.watchdog as t_watchdog  # noqa: E402
from repro.core.blockpool import BlockPool as JaxBlockPool  # noqa: E402
from repro.serving.scheduler import Scheduler as JaxScheduler  # noqa: E402
from repro_torch.core import offload  # noqa: E402
from repro_torch.core.blockpool import BlockPool  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(f=jax_faults, t=jax_transfer,
                                 w=jax_watchdog),
    "port": types.SimpleNamespace(f=t_faults, t=t_transfer, w=t_watchdog),
}


@pytest.fixture(params=list(PKGS))
def rt(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# FaultPlan
# ---------------------------------------------------------------------------

def _draw_seq(plan, site, n=200):
    return [(ev.kind if ev else None) for ev in
            (plan.draw(site) for _ in range(n))]


def test_plan_deterministic_per_seed(rt):
    probs = {"*": {"fail": 0.1, "stall": 0.1, "exhaust": 0.05}}
    a = _draw_seq(rt.f.FaultPlan(seed=3, probs=probs), "kv_fetch")
    b = _draw_seq(rt.f.FaultPlan(seed=3, probs=probs), "kv_fetch")
    c = _draw_seq(rt.f.FaultPlan(seed=4, probs=probs), "kv_fetch")
    assert a == b
    assert a != c
    assert any(k is not None for k in a)


def test_scripted_trace_window(rt):
    plan = rt.f.FaultPlan(trace=[rt.f.FaultEvent("kv_fetch", "fail",
                                                 after=2, count=3)])
    kinds = _draw_seq(plan, "kv_fetch", n=8)
    assert kinds == [None, None, "fail", "fail", "fail", None, None, None]
    assert _draw_seq(plan, "kv_spill", n=8) == [None] * 8


def test_scripted_wins_over_probabilistic(rt):
    plan = rt.f.FaultPlan(seed=0, probs={"x": 1.0},
                          trace=[rt.f.FaultEvent("x", "stall", after=0,
                                                 count=1, stall_ms=99.0)])
    ev = plan.draw("x")
    assert ev.kind == "stall" and ev.stall_ms == 99.0


def test_max_faults_bounds_injections(rt):
    plan = rt.f.FaultPlan(seed=0, probs={"*": 1.0}, max_faults=5)
    kinds = _draw_seq(plan, "s", n=50)
    assert sum(k is not None for k in kinds) == 5
    assert plan.injected == 5


def test_per_site_probability_isolation(rt):
    plan = rt.f.FaultPlan(seed=0, probs={"only_here": 1.0})
    assert all(k == "fail" for k in _draw_seq(plan, "only_here", 10))
    assert all(k is None for k in _draw_seq(plan, "elsewhere", 10))


def test_injector_counts_and_raise_for(rt):
    f = rt.f
    inj = f.FaultInjector(f.FaultPlan(
        trace=[f.FaultEvent("host_alloc", "hostmem", after=0, count=1),
               f.FaultEvent("host_alloc", "fail", after=1, count=1)]))
    with pytest.raises(f.HostMemoryError) as ei:
        inj.raise_for("host_alloc")
    assert ei.value.site == "host_alloc"
    with pytest.raises(f.HostMemoryError):
        inj.raise_for("host_alloc")
    inj.raise_for("host_alloc")                    # past the window: no-op
    assert inj.counts == {"host_alloc/hostmem": 1, "host_alloc/fail": 1}
    assert inj.total() == 2
    assert isinstance(ei.value, f.OffloadFaultError)
    assert isinstance(ei.value, RuntimeError)


def test_unarmed_injector_is_noop(rt):
    inj = rt.f.FaultInjector()
    assert not inj.armed
    assert inj.fire("x") is None
    assert inj.stall_s("x") == 0.0
    inj.raise_for("x")
    assert inj.total() == 0


def test_fault_kinds_closed(rt):
    with pytest.raises(AssertionError):
        rt.f.FaultEvent("s", "meteor_strike")
    assert set(rt.f.FAULT_KINDS) == {"fail", "stall", "partial", "hostmem",
                                     "exhaust"}
    assert rt.f.LADDER_LEVELS == jax_faults.LADDER_LEVELS


# ---------------------------------------------------------------------------
# TransferEngine
# ---------------------------------------------------------------------------

def _xfer(rt, trace, **kw):
    inj = rt.f.FaultInjector(rt.f.FaultPlan(trace=trace))
    return rt.t.TransferEngine(inj, **kw)


def test_transfer_retries_then_succeeds(rt):
    eng = _xfer(rt, [rt.f.FaultEvent("t", "fail", after=0, count=3)],
                max_retries=4)
    ran = []
    out = eng.run("t", lambda: ran.append(1) or "ok", nbytes=128)
    assert out == "ok" and ran == [1]
    assert eng.retries == 3 and eng.aborts == 0 and eng.ok_ops == 1
    assert eng.bytes_moved == 128


def test_transfer_abort_after_budget(rt):
    eng = _xfer(rt, [rt.f.FaultEvent("t", "fail", after=0, count=10)],
                max_retries=2)
    with pytest.raises(rt.f.TransientTransferError):
        eng.run("t", lambda: "never")
    assert eng.retries == 2 and eng.aborts == 1 and eng.ok_ops == 0


def test_run_mandatory_survives_exhausted_cycles(rt):
    eng = _xfer(rt, [rt.f.FaultEvent("t", "fail", after=0, count=7)],
                max_retries=2)
    assert eng.run_mandatory("t", lambda: "landed") == "landed"
    assert eng.retries >= 1
    assert eng.aborts >= 1 and eng.ok_ops == 1


def test_run_mandatory_hostmem_hook_then_reissue(rt):
    eng = _xfer(rt, [rt.f.FaultEvent("t", "hostmem", after=0, count=1)])
    demoted = []
    out = eng.run_mandatory("t", lambda: "ok",
                            on_hostmem=lambda: demoted.append(1))
    assert out == "ok" and demoted == [1]
    assert eng.hostmem_faults == 1


def test_hostmem_without_hook_propagates(rt):
    eng = _xfer(rt, [rt.f.FaultEvent("t", "hostmem", after=0, count=1)])
    with pytest.raises(rt.f.HostMemoryError):
        eng.run_mandatory("t", lambda: "ok")


def test_injected_stall_books_and_aborts_by_policy(rt):
    def mk(policy):
        return _xfer(rt, [rt.f.FaultEvent("t", "stall", after=3, count=1,
                                          stall_ms=60_000.0)],
                     min_deadline_s=1e-4, deadline_factor=2.0,
                     stall_policy=policy)
    eng = mk("log")
    for _ in range(4):
        eng.run("t", lambda: None)
    assert eng.stalls == 1 and eng.ok_ops == 4
    eng = mk("abort")
    for _ in range(3):
        eng.run("t", lambda: None)
    with pytest.raises(rt.f.StallTimeout):
        eng.run("t", lambda: None)


def test_transfer_feeds_ladder(rt):
    ladder = rt.f.DegradationLadder(down_after=2, up_after=3)
    eng = _xfer(rt, [rt.f.FaultEvent("t", "fail", after=0, count=2)],
                max_retries=4, ladder=ladder)
    eng.run("t", lambda: None)
    assert ladder.pending() and ladder.target == 1


def test_stats_shape(rt):
    eng = rt.t.TransferEngine()
    eng.run("a", lambda: None, nbytes=10)
    s = eng.stats()
    assert s["ok_ops"] == 1 and s["bytes_moved"] == 10
    assert "a" in s["deadline_s"]


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------

def test_watchdog_ewma_updates_every_step(rt):
    wd = rt.w.Watchdog(deadline_factor=10.0, min_deadline_s=0.0)
    wd.observe(1.0)
    assert wd.ewma == pytest.approx(1.0)
    wd.observe(2.0)
    assert wd.ewma > 1.0
    assert wd.steps_seen == 2


def test_watchdog_zero_first_step_does_not_reseed(rt):
    wd = rt.w.Watchdog(deadline_factor=10.0, min_deadline_s=1.0)
    wd.observe(0.0)
    wd.observe(5.0)
    e1 = wd.ewma
    assert e1 > 0.0
    wd.observe(5.0)
    assert wd.ewma > e1


def test_watchdog_updates_before_abort_raise(rt):
    wd = rt.w.Watchdog(deadline_factor=2.0, min_deadline_s=0.0,
                       policy="abort")
    wd.observe(1.0)
    before = wd.ewma
    with pytest.raises(rt.w.StragglerError):
        wd.observe(100.0)
    assert wd.steps_seen == 2 and wd.slow_steps == 1
    assert before < wd.ewma <= before + wd.alpha * 2.0 * before + 1e-9


def test_watchdog_step_end_virtual_seconds(rt):
    wd = rt.w.Watchdog(deadline_factor=1.5, min_deadline_s=1e-4)
    wd.step_start()
    assert wd.step_end()
    wd.step_start()
    assert not wd.step_end(extra_s=10.0)
    assert wd.slow_steps == 1


# ---------------------------------------------------------------------------
# DegradationLadder
# ---------------------------------------------------------------------------

def test_ladder_down_after_threshold_and_one_rung_per_apply_loop(rt):
    lad = rt.f.DegradationLadder(down_after=3, up_after=5)
    for _ in range(2):
        lad.note_fault("kv_fetch")
    assert not lad.pending()
    lad.note_fault("kv_fetch")
    assert lad.pending() and lad.target == 1
    steps = []
    evs = lad.apply(lambda o, n, d: steps.append((o, n, d)), tick=7)
    assert steps == [(0, 1, "down")]
    assert lad.level == 1 and lad.level_name == "pageable_host"
    assert evs[0]["reason"] == "kv_fetch" and evs[0]["tick"] == 7


def test_ladder_hysteresis_up_slower_than_down(rt):
    lad = rt.f.DegradationLadder(down_after=2, up_after=6)
    for _ in range(2):
        lad.note_fault("x")
    lad.apply()
    for _ in range(5):
        lad.note_ok()
    assert not lad.pending()
    lad.note_ok()
    assert lad.pending() and lad.target == 0
    lad.apply()
    assert lad.level == 0
    assert lad.demotions == 1 and lad.promotions == 1
    with pytest.raises(AssertionError):
        rt.f.DegradationLadder(down_after=3, up_after=3)


def test_ladder_ok_resets_fault_streak(rt):
    lad = rt.f.DegradationLadder(down_after=3, up_after=4)
    lad.note_fault("x")
    lad.note_fault("x")
    lad.note_ok()
    lad.note_fault("x")
    lad.note_fault("x")
    assert not lad.pending()


def test_ladder_force_at_least_and_multi_rung_apply(rt):
    levels = rt.f.LADDER_LEVELS
    lad = rt.f.DegradationLadder(down_after=2, up_after=3)
    lad.force_at_least("lockstep", site="host_alloc")
    assert lad.target == levels.index("lockstep")
    crossings = []
    lad.apply(lambda o, n, d: crossings.append((levels[n], d)))
    assert crossings == [("pageable_host", "down"), ("no_predict", "down"),
                         ("lockstep", "down")]
    lad.force_at_least("pageable_host")
    assert not lad.pending()


def test_ladder_full_descent_and_recovery_events_pair_up(rt):
    levels = rt.f.LADDER_LEVELS
    lad = rt.f.DegradationLadder(down_after=1, up_after=2)
    for _ in range(len(levels) + 3):
        lad.note_fault("s")
    lad.apply(tick=1)
    assert lad.level == len(levels) - 1
    assert lad.level_name == "admission_shed"
    for _ in range(2 * len(levels)):
        lad.note_ok()
        lad.apply(tick=2)
    assert lad.level == 0 and lad.level_name == "healthy"
    downs = [e for e in lad.events if e["direction"] == "down"]
    ups = [e for e in lad.events if e["direction"] == "up"]
    assert len(downs) == len(ups) == len(levels) - 1
    assert [e["to"] for e in downs] == list(levels[1:])
    assert [e["to"] for e in ups] == list(reversed(levels[:-1]))
    assert [e["seq"] for e in lad.events] == list(range(len(lad.events)))


def test_ladder_max_level_clamp(rt):
    lad = rt.f.DegradationLadder(down_after=1, up_after=2, max_level=2)
    for _ in range(50):
        lad.note_fault("s")
    lad.apply()
    assert lad.level == 2
    lad.force_at_least("admission_shed")
    lad.apply()
    assert lad.level == 2


# ---------------------------------------------------------------------------
# Cross-package draws: the seeded stream the engine parity rests on
# ---------------------------------------------------------------------------

SITES = ("kv_spill", "kv_fetch", "kv_pool", "expert_copy", "plan_drain",
         "host_alloc", "dispatch")

PLANS = {
    "star_mix": dict(seed=0, probs={"*": {"fail": 0.06, "stall": 0.04,
                                          "partial": 0.04, "exhaust": 0.03,
                                          "hostmem": 0.01}}),
    "scalar_sites": dict(seed=7, probs={"kv_fetch": 0.3, "plan_drain": 0.5}),
    "scripted": dict(seed=11, probs={"*": 0.1},
                     trace=[("kv_pool", "exhaust", 3, 4),
                            ("expert_copy", "hostmem", 0, 2),
                            ("dispatch", "stall", 5, 3)]),
    "bounded": dict(seed=2, probs={"*": {"fail": 0.5, "stall": 0.5}},
                    max_faults=40),
    "site_over_star": dict(seed=5, probs={"*": 0.05,
                                          "kv_spill": {"partial": 0.4}},
                           trace=[("kv_spill", "fail", 10, 5)],
                           stall_ms=75.0, partial_frac=0.25),
}


def _plan(f, spec):
    kw = dict(spec)
    kw["trace"] = [f.FaultEvent(s, k, after=a, count=c)
                   for s, k, a, c in kw.get("trace", ())]
    return f.FaultPlan(**kw)


def _site_order(n=200, seed=99):
    rng = np.random.default_rng(seed)
    return [SITES[int(i)] for i in rng.integers(0, len(SITES), n)]


@pytest.mark.parametrize("name", list(PLANS))
def test_plans_draw_equal_kinds_across_packages(name):
    a, b = _plan(jax_faults, PLANS[name]), _plan(t_faults, PLANS[name])
    sa = [(s, (ev.kind, ev.stall_ms, ev.frac) if ev else None)
          for s, ev in ((s, a.draw(s)) for s in _site_order())]
    sb = [(s, (ev.kind, ev.stall_ms, ev.frac) if ev else None)
          for s, ev in ((s, b.draw(s)) for s in _site_order())]
    assert sa == sb
    assert a.ops == b.ops and a.injected == b.injected
    assert a.injected > 0


@pytest.mark.parametrize("name", list(PLANS))
def test_transfer_engines_book_equal_across_packages(name, monkeypatch):
    """Mandatory ops at every site over the same plan, with the clock held
    still (only virtual stall seconds count): the same counters, deadlines
    and ladder events in both packages."""
    for m in (jax_transfer, t_transfer):
        monkeypatch.setattr(m, "time", types.SimpleNamespace(
            perf_counter=lambda: 0.0, sleep=lambda s: None))
    books = []
    for f, t in ((jax_faults, jax_transfer), (t_faults, t_transfer)):
        ladder = f.DegradationLadder(down_after=2, up_after=5)
        inj = f.FaultInjector(_plan(f, PLANS[name]))
        eng = t.TransferEngine(inj, max_retries=2, ladder=ladder)
        for site in _site_order(120, seed=3):
            eng.run_mandatory(site, lambda: None, nbytes=64,
                              on_hostmem=lambda: None)
            ladder.apply()
        books.append((eng.stats(), dict(inj.counts), list(ladder.events)))
    assert books[0] == books[1]


# ---------------------------------------------------------------------------
# The port's chokepoints: the BlockPool's kv_pool site, host_alloc
# ---------------------------------------------------------------------------

def test_blockpool_kv_pool_site_matches_jax():
    """Both packages' pools under the same plan refuse the same ensure
    calls (flagged injected) and plan the same ops otherwise."""
    spec = dict(seed=4, probs={"kv_pool": {"exhaust": 0.3, "fail": 0.1,
                                           "stall": 0.2}})
    pools = [P(4, 4, 6, 128, faults=f.FaultInjector(_plan(f, spec)))
             for P, f in ((JaxBlockPool, jax_faults), (BlockPool, t_faults))]
    rng = np.random.default_rng(0)
    refused = 0
    for _ in range(60):
        slot, n = int(rng.integers(0, 4)), int(rng.integers(1, 5))
        got = []
        for pool in pools:
            ops, ok, nxt = pool.ensure_range(slot, 0, n, (slot,))
            got.append((ops, ok, nxt, pool.last_refusal_injected))
        assert got[0] == got[1]
        refused += got[0][3]
        if rng.random() < 0.2:
            for pool in pools:
                pool.free_slot(slot)
    assert refused > 0
    assert vars(pools[0].counters) == vars(pools[1].counters)
    pools[1].check_invariants()


def test_host_store_host_alloc_site():
    inj = t_faults.FaultInjector(t_faults.FaultPlan(
        trace=[t_faults.FaultEvent("host_alloc", "fail", after=1, count=1)]))
    cpu = torch.device("cpu")
    t = offload.host_store((3, 4), torch.float32, cpu, faults=inj)
    assert t.shape == (3, 4) and not t.any() and not t.is_pinned()
    with pytest.raises(t_faults.HostMemoryError) as ei:
        offload.host_store((3, 4), torch.float32, cpu, faults=inj)
    assert ei.value.site == "host_alloc"
    assert isinstance(ei.value, RuntimeError)
    assert inj.counts == {"host_alloc/fail": 1}
    p = offload.pageable_copy(t + 1)
    assert not p.is_pinned() and bool((p == 1).all())


# ---------------------------------------------------------------------------
# Scheduler SLO-shedding, each beside the JAX Scheduler's trace
# ---------------------------------------------------------------------------

def _scheds():
    kw = dict(ubatch=2, num_ubs=2, cache_tokens=512, gen_len=8,
              max_input_len=64)
    return JaxScheduler(**kw), Scheduler(**kw)


def _state(s):
    return ([(r.rid, r.shed, r.aborted, r.done, list(r.generated),
              r.priority, r.preemptions) for r in s.requests.values()],
            [q.rid for q in s.queue], s.shed_count, s.shed_priority)


def test_shed_disabled_by_default():
    for s in _scheds():
        rid = s.submit(np.arange(4), 4, priority=5)
        assert not s.requests[rid].shed and s.queue
    a, b = _scheds()
    a.submit(np.arange(4), 4, priority=5)
    b.submit(np.arange(4), 4, priority=5)
    assert _state(a) == _state(b)


def test_shed_priority_threshold_at_submit():
    states = []
    for s in _scheds():
        s.shed_priority = 1
        keep = s.submit(np.arange(4), 4, priority=0)
        drop = s.submit(np.arange(4), 4, priority=1)
        assert not s.requests[keep].shed
        r = s.requests[drop]
        assert r.shed and r.aborted and r.done and not r.generated
        assert s.shed_count == 1
        assert [q.rid for q in s.queue] == [keep]
        states.append(_state(s))
    assert states[0] == states[1]


def test_shed_queued_but_never_preempted_requests():
    states = []
    for s in _scheds():
        a = s.submit(np.arange(4), 6, priority=1)
        b = s.submit(np.arange(4), 6, priority=1)
        slots = s.admit_to_slots()
        assert [sl.req.rid for sl in slots] == [a, b]
        for sl in slots:
            s.start_decode(sl)
        s.requests[a].generated.extend([7, 8])
        s.preempt(next(sl for sl in slots if sl.req.rid == a))
        c = s.submit(np.arange(4), 6, priority=1)
        s.shed_priority = 1
        admitted = s.admit_to_slots()
        assert [sl.req.rid for sl in admitted] == [a]
        assert s.requests[a].generated == [7, 8]
        assert s.requests[c].shed and not s.requests[a].shed
        assert s.shed_count == 1
        states.append((_state(s), [(sl.gid, sl.row) for sl in admitted]))
    assert states[0] == states[1]


def test_shed_static_admit_path():
    states = []
    for s in _scheds():
        s.shed_priority = 2
        s.submit(np.arange(4), 4, priority=0)
        s.submit(np.arange(4), 4, priority=3)
        mbs = s.admit()
        admitted = {r.rid for mb in mbs for r in mb}
        assert admitted == {0}
        assert s.requests[1].shed and s.shed_count == 1
        states.append((_state(s), [[r.rid for r in mb] for mb in mbs]))
    assert states[0] == states[1]
