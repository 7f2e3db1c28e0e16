"""The port's fault plane end to end, against the JAX engine under the same
fault schedule (the mirror of ``tests/test_chaos.py``).

Invariant: an injected fault schedule may cost throughput — retries,
stalls, degradation rungs — but never changes tokens.  Every case runs the
JAX engine and the port on the same weights (mixtral smoke in float32,
``jax.random.key(1)``), the same workload and the same seeded
``FaultPlan``, and holds:

  * the port's transcripts equal to the JAX engine's and to the port's own
    fault-free run;
  * the port's whole ``fault_traffic()`` equal to the JAX one's (deadlines
    within 1e-9), and ``kv_traffic()``, ``weight_traffic()`` and the plan's
    per-site op counts equal — so both engines fired the same sites in the
    same order;
  * the reference's own checks: something was injected, the BlockPool's
    invariants hold, residency occupancy stays within capacity.

Cases: ``test_chaos.py``'s five modes at seeds 0 and 1 with the dispatch
watchdog on (its fuzz modes at seeds 2..7 are in
``tests/test_torch_chaos_fuzz.py``); the ladder's full round trip (every rung down and back, every
flag restored) and the admission shed, each with the JAX engine beside it;
and a ``host_alloc`` fault scripted at op 0, so the engine starts at
``pageable_host`` and re-probes on the way up.

Both engines run the default MoE (dense, as the reference's chaos test
runs it): the capacity-bucketed grouped MoE drops tokens by batch
composition, so a recompute preemption — which the lockstep rung's
narrower protect set can move at r_c 0.25 — would change tokens there in
both engines alike.

Determinism: ``time`` in both packages' ``runtime/transfer.py`` and
``runtime/watchdog.py`` is replaced by a frozen clock for each test, so only
the schedule's virtual stall seconds count.  The JAX engine's host tier is
put on its pageable numpy fall-back by patching
``repro.core.offload.supports_host_offload`` to return False (its
``pinned_host`` tier fails on this CPU backend); patching
``pinned_host_sharding`` instead would skip the ``host_alloc`` draw and
desynchronize the seeded stream.  On the CPU the port's tier is plain
memory, also not pinned, so demotion and re-promotion move nothing here:
only the card exercises them (``chip_smoke.py``'s ``chaos`` phase and the
``cuda`` test below).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.runtime.faults as jax_faults  # noqa: E402
import repro.runtime.transfer as jax_transfer  # noqa: E402
import repro.runtime.watchdog as jax_watchdog  # noqa: E402
import repro_torch.runtime.faults as t_faults  # noqa: E402
import repro_torch.runtime.transfer as t_transfer  # noqa: E402
import repro_torch.runtime.watchdog as t_watchdog  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import offload as jax_offload  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import ExecPolicy  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

SITES = ("kv_spill", "kv_fetch", "kv_pool", "expert_copy", "plan_drain",
         "host_alloc", "dispatch")

MODES = {
    "plain": {},
    "kv_paged": dict(kv_paged=True, kv_gpu_ratio=0.25, kv_prefetch=True),
    "expert_paged": dict(expert_paged=True, w_gpu_ratio=0.5, prefetch=True,
                         predict=True),
    "expert_module_kv": dict(expert_paged=True, w_gpu_ratio=0.5,
                             prefetch=True, predict=True, module_batch=True,
                             kv_paged=True, kv_gpu_ratio=0.25,
                             kv_prefetch=True),
    "overlap_kv": dict(overlap=True, prefill_chunk=16, kv_paged=True,
                       kv_gpu_ratio=0.25),
}
FUZZ_MODES = ("kv_paged", "expert_module_kv")
SLOTS = dict(ubatch=2, num_ubs=2, max_seq=64, decode_chunk=4)


class _FrozenClock:
    """Stands in for the ``time`` module of the runtime modules."""

    @staticmethod
    def perf_counter():
        return 0.0

    monotonic = time = perf_counter

    @staticmethod
    def sleep(_s):
        return None


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    for m in (jax_transfer, jax_watchdog, t_transfer, t_watchdog):
        monkeypatch.setattr(m, "time", _FrozenClock)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config("mixtral-8x7b").smoke(),
                              dtype="float32")
    params = init_params(cfg, jax.random.key(1))
    tcfg = dataclasses.replace(t_get_config("mixtral-8x7b").smoke(),
                               dtype="float32")
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    return types.SimpleNamespace(cfg=cfg, params=params, tcfg=tcfg,
                                 tparams=tparams, baselines={})


def _work(vocab, seed=0, n=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, int(rng.integers(4, 20))),
             4 if i % 2 == 0 else 12) for i in range(n)]


def _schedule(f, seed):
    """``test_chaos._schedule`` over faults module `f`: probabilistic
    faults at every site plus a scripted burst drawn from the seed."""
    rng = np.random.default_rng(seed)
    site = SITES[int(rng.integers(0, len(SITES)))]
    kind = ("fail", "stall", "partial", "exhaust")[int(rng.integers(0, 4))]
    return f.FaultPlan(
        seed=seed,
        probs={"*": {"fail": 0.06, "stall": 0.04, "partial": 0.04,
                     "exhaust": 0.03, "hostmem": 0.01}},
        trace=[f.FaultEvent(site, kind, after=int(rng.integers(0, 10)),
                            count=int(rng.integers(1, 6)))],
        stall_ms=float(rng.integers(50, 5000)),
        max_faults=int(rng.integers(40, 200)))


def _jax_engine(s, kw):
    # the port's watchdog default (off), unless the case sets it
    kw = dict(dict(watchdog=EngineConfig.watchdog), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "supports_host_offload", lambda: False)
        return JaxEngine(s.cfg, s.params,
                         JaxEngineConfig(**SLOTS, **kw))


def _port_engine(s, kw):
    return Engine(s.tcfg, s.tparams, EngineConfig(**SLOTS, **kw),
                  device="cpu")


def _serve(eng, work):
    rids = [eng.submit(p, q) for p, q in work]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_offload, "supports_host_offload", lambda: False)
        out = eng.run_until_idle()
    return rids, out


def _baseline(s, mode, work_seed, kw):
    """The port's fault-free run of a mode and workload (cached)."""
    key = (mode, work_seed)
    if key not in s.baselines:
        _, out = _serve(_port_engine(s, kw), _work(s.cfg.vocab_size,
                                                   seed=work_seed))
        s.baselines[key] = out
    return s.baselines[key]


def _same_fault_traffic(a, b):
    a, b = dict(a), dict(b)
    da, db = a.pop("deadline_s"), b.pop("deadline_s")
    assert a == b
    assert set(da) == set(db)
    for site in da:
        assert abs(da[site] - db[site]) <= 1e-9, site


def _check_parity(jeng, teng, jout, tout):
    assert tout == jout
    _same_fault_traffic(teng.fault_traffic(), jeng.fault_traffic())
    assert teng.kv_traffic() == jeng.kv_traffic()
    assert teng.weight_traffic() == jeng.weight_traffic()
    if jeng.ecfg.fault_plan is not None:
        assert teng.ecfg.fault_plan.ops == jeng.ecfg.fault_plan.ops
        assert (teng.ecfg.fault_plan.injected
                == jeng.ecfg.fault_plan.injected)
    assert ([r.preemptions for r in teng.scheduler.requests.values()]
            == [r.preemptions for r in jeng.scheduler.requests.values()])


def _check_chaos(s, mode, seed, work_seed):
    """One schedule in both engines (watchdog on, as the reference's
    chaos check runs it)."""
    kw = dict(MODES[mode], degrade_down_after=2, degrade_up_after=5,
              watchdog=True)
    work = _work(s.cfg.vocab_size, seed=work_seed)
    jeng = _jax_engine(s, dict(kw, fault_plan=_schedule(jax_faults, seed)))
    _, jout = _serve(jeng, work)
    teng = _port_engine(s, dict(kw, fault_plan=_schedule(t_faults, seed)))
    _, tout = _serve(teng, work)
    _check_parity(jeng, teng, jout, tout)
    assert tout == _baseline(s, mode, work_seed, MODES[mode]), \
        f"tokens changed under fault seed {seed}"
    ft = teng.fault_traffic()
    assert ft["injected_total"] > 0, "schedule injected nothing"
    assert set(ft["injected"]) <= {f"{site}/{k}" for site in SITES
                                   for k in t_faults.FAULT_KINDS}
    if teng._kv is not None:
        teng._kv.check_invariants()
    for r in teng.residency.values():
        assert r.occupancy() <= r.capacity
    return ft


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("mode", list(MODES))
def test_chaos_transcripts_match_jax(setup, mode, seed):
    _check_chaos(setup, mode, seed, work_seed=0)


def test_ladder_full_round_trip_matches_jax(setup):
    """A p 0.9 expert_copy burst walks the ladder to its bottom rung; a
    second, fault-free wave walks it back to healthy.  Tokens never change
    (priority 0 is never shed), every rung down has its re-promotion, and
    every degraded-mode flag reverts — in both engines, step for step."""
    s = setup
    kw = dict(MODES["expert_module_kv"], watchdog=False,
              degrade_down_after=1, degrade_up_after=8)
    work = _work(s.cfg.vocab_size, n=10)
    work2 = _work(s.cfg.vocab_size, seed=5, n=8)
    engines = []
    for f, make in ((jax_faults, _jax_engine), (t_faults, _port_engine)):
        plan = f.FaultPlan(seed=0, probs={"expert_copy": 0.9},
                           max_faults=150)
        eng = make(s, dict(kw, fault_plan=plan))
        _, out = _serve(eng, work)
        ft1 = eng.fault_traffic()
        rids2, out2 = _serve(eng, work2)
        engines.append((eng, out, ft1, [out2[r] for r in rids2]))
    (jeng, jout, jft1, jout2), (teng, tout, tft1, tout2) = engines
    _same_fault_traffic(tft1, jft1)
    _check_parity(jeng, teng, jout, tout)
    assert tout2 == jout2
    fresh = _port_engine(s, dict(MODES["expert_module_kv"]))
    _, base1 = _serve(fresh, work)
    fresh2 = _port_engine(s, dict(MODES["expert_module_kv"]))
    rb, base2 = _serve(fresh2, work2)
    assert {r: tout[r] for r in base1} == base1
    assert tout2 == [base2[r] for r in rb]
    downs = [e for e in tft1["degradation_events"]
             if e["direction"] == "down"]
    assert {e["to"] for e in downs} == set(t_faults.LADDER_LEVELS[1:])
    assert tft1["retries"] > 0 and tft1["injected_total"] > 0
    assert tft1["shed_requests"] == 0
    ft = teng.fault_traffic()
    ups = [e for e in ft["degradation_events"] if e["direction"] == "up"]
    downs = [e for e in ft["degradation_events"] if e["direction"] == "down"]
    assert len(downs) == len(ups)
    assert ft["level_name"] == "healthy"
    assert teng._mg == teng._mg_base > 1
    assert teng._windows == [[0, 1]]
    assert not teng._degraded_no_predict
    assert teng.scheduler.shed_priority is None
    for r in teng.residency.values():
        assert r.limit is None


def test_admission_shed_matches_jax(setup):
    """With the ladder pinned at admission_shed, priority-1 submissions are
    shed while the priority-0 transcripts equal the healthy run's."""
    s = setup
    kw = MODES["kv_paged"]
    work = _work(s.cfg.vocab_size, n=6)
    _, base = _serve(_port_engine(s, kw), work)
    got = []
    for make in (_jax_engine, _port_engine):
        eng = make(s, kw)
        eng._ladder.force_at_least("admission_shed", site="test")
        rids0 = [eng.submit(p, q) for p, q in work]
        rids1 = [eng.submit(p, q, priority=1) for p, q in work[:3]]
        _, out = _serve(eng, [])
        got.append((eng, out, rids0, rids1))
    (jeng, jout, _, _), (teng, tout, rids0, rids1) = got
    _check_parity(jeng, teng, jout, tout)
    assert {rid: tout[rid] for rid in rids0} == base
    for rid in rids1:
        r = teng.scheduler.requests[rid]
        assert r.shed and r.generated == []
    assert teng.fault_traffic()["shed_requests"] == len(rids1)


def test_host_alloc_refused_at_construction_matches_jax(setup):
    """A ``host_alloc`` fault scripted at op 0 refuses the KV host tier at
    construction: the engine starts on the pageable tier at
    ``pageable_host``, serves the same tokens, and the ladder's way back up
    re-probes (a second ``host_alloc`` draw) — as the JAX engine does."""
    s = setup
    kw = dict(MODES["kv_paged"], degrade_up_after=4)
    work = _work(s.cfg.vocab_size)
    engines = []
    for f, make in ((jax_faults, _jax_engine), (t_faults, _port_engine)):
        plan = f.FaultPlan(trace=[f.FaultEvent("host_alloc", "hostmem",
                                               after=0, count=1)])
        eng = make(s, dict(kw, fault_plan=plan))
        assert eng._ladder.target == 1 and eng._ladder.level == 0
        _, out = _serve(eng, work)
        engines.append((eng, out))
    (jeng, jout), (teng, tout) = engines
    _check_parity(jeng, teng, jout, tout)
    assert tout == _baseline(s, "kv_paged", 0, MODES["kv_paged"])
    ft = teng.fault_traffic()
    assert ft["injected"] == {"host_alloc/hostmem": 1}
    ev = ft["degradation_events"]
    assert (ev[0]["to"], ev[0]["reason"], ev[0]["tick"]) == (
        "pageable_host", "host_alloc", 0)
    assert ft["level_name"] == "healthy" and ft["promotions"] == 1
    assert teng.ecfg.fault_plan.ops["host_alloc"] == 2
    assert not ft["host_tier_pinned"]          # the CPU tier is never pinned


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_host_tier_demotion_round_trip_cuda():
    """On the card: a pinned KV tier with spilled blocks (their D2H copies
    still in flight on the stream) is demoted to pageable memory and
    re-promoted through the ladder; every block's bytes survive both
    directions, the pinned flags follow, and the demotion is a ladder
    event even when a healthy streak undid its rung before the tick."""
    from repro_torch.models.params import init_params as t_init
    cfg = dataclasses.replace(t_get_config("mixtral-8x7b").smoke(),
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    eng = Engine(cfg, t_init(cfg, gen, device="cuda"),
                 EngineConfig(**SLOTS, **MODES["kv_paged"]),
                 ExecPolicy(moe_impl="grouped"), device="cuda")
    assert eng.fault_traffic()["host_tier_pinned"]
    for g in eng._kv_arena.values():
        for a in g.values():
            if a.is_floating_point():
                a.normal_()
            else:
                a.random_(0, 100)
    nblk = eng._kv.device_blocks
    for pb in range(nblk):
        eng._kv_spill_op(pb, pb)              # non_blocking D2H, in flight
    eng._demote_host_tier()

    def check(pinned):
        for key, g in eng._kv_arena.items():
            for name, a in g.items():
                t = eng._kv_host[key][name]
                assert t.is_pinned() == pinned
                for pb in range(nblk):
                    assert torch.equal(t[pb], eng._kv_block(a, name, pb)
                                       .cpu()), (key, name, pb)
        assert eng.fault_traffic()["host_tier_pinned"] == pinned

    check(False)
    # a healthy streak lowers the forced rung's target before the next
    # safe point: the tick still records the demotion, and the way back
    # up re-pins the tier
    lad = eng._ladder
    for _ in range(lad.up_after):
        lad.note_ok()
    assert lad.target == 0 and lad.level == 0
    eng._ladder_tick()
    assert lad.level == 1 and lad.events[-1]["to"] == "pageable_host"
    check(False)
    for _ in range(lad.up_after):
        lad.note_ok()
    eng._ladder_tick()
    assert lad.level == 0 and lad.events[-1]["to"] == "healthy"
    check(True)
