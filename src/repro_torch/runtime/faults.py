"""Fault injection and the degradation ladder of the offload plane (a copy
of ``repro/runtime/faults.py``; the port keeps its own).

The serving engine's throughput story (CGOPipe) assumes the CPU–GPU link
and the host tier never stall; this module is the story for when they do.
Three pieces:

  * an **error taxonomy**: a failed or stalled transfer is a
    `TransientTransferError` / `StallTimeout`, a failed pinned-host
    allocation a `HostMemoryError` — all subclasses of `OffloadFaultError`
    (a ``RuntimeError``) carrying the fault site;
  * a seeded, schedulable **FaultPlan**: per-site fault probabilities
    and/or a scripted trace of `FaultEvent`s (fail / stall-N-ms /
    partial-plan / hostmem / pool-exhaust), drawn deterministically per
    site-op, so a chaos schedule replays bit for bit from its seed, and
    the port and the JAX engine fire the same sites in the same order.
    The engine consults it through a `FaultInjector` at the chokepoints
    every H2D/D2H byte already flows through: ``paging.transfer_plan``
    drains, `BlockPool` spill/fetch execution and pool refusals, expert
    span copies and ``core/offload.py``'s pinned host tier;
  * a reversible **DegradationLadder**: persistent faults step the engine
    down one rung at a time (pinned → pageable host tier, suspend
    predictive prefetch, clamp module windows to lockstep, shrink the
    residency pool / drop replica pins, shed at admission), and a
    hysteresis-guarded streak of healthy operations steps it back up.
    Every transition is an emitted structured event.

Invariant: faults may cost throughput but never change tokens — every
rung only moves *where bytes stream from and when*, never what a decode
dispatch computes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class OffloadFaultError(RuntimeError):
    """Base class for offload-plane faults; carries the fault site."""

    def __init__(self, msg: str, site: str = "?"):
        super().__init__(msg)
        self.site = site


class TransientTransferError(OffloadFaultError):
    """A transfer (H2D/D2H plan op, span fill) failed; retryable."""


class HostMemoryError(OffloadFaultError):
    """A pinned-host allocation / pinned-tier write failed.  Not
    retryable at the same tier — the caller demotes to pageable and
    re-issues (the degradation ladder re-probes on promotion)."""


class StallTimeout(OffloadFaultError):
    """An op exceeded its EWMA-based deadline (transfer stall)."""


# ---------------------------------------------------------------------------
# Fault plan
# ---------------------------------------------------------------------------

FAULT_KINDS = ("fail", "stall", "partial", "hostmem", "exhaust")


@dataclass
class FaultEvent:
    """One scripted fault: fires on the `site`'s ops [after, after+count).

    kind ∈ FAULT_KINDS: "fail" → TransientTransferError, "hostmem" →
    HostMemoryError, "exhaust" → pool refusal (BlockPool behaves as
    arena-exhausted), "stall" → the op proceeds but `stall_ms` of
    (virtual) latency is charged against its deadline, "partial" → only
    a `frac` prefix of a drained transfer-plan slice completes (the rest
    re-queues)."""
    site: str
    kind: str = "fail"
    after: int = 0
    count: int = 1
    stall_ms: float = 0.0
    frac: float = 0.5

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind


class FaultPlan:
    """Seeded, schedulable fault source.

    ``probs`` maps a site name (or "*" for any site) to either a float —
    the per-op probability of a "fail" — or a {kind: prob} dict (at most
    one kind fires per op; probabilities are taken in kind order).
    ``trace`` is a sequence of scripted `FaultEvent`s keyed on the
    site's own op counter, so a schedule like "the 5th kv_fetch fails
    three times" is exact and replayable.  Scripted events win over the
    probabilistic draw.  ``max_faults`` bounds total injections — the
    backstop that keeps a high-probability plan from starving a
    mandatory retry loop forever.

    Determinism: draws depend only on (seed, per-site op order), so the
    same engine run under the same plan replays identically — the chaos
    fuzzer's whole premise.
    """

    def __init__(self, seed: int = 0,
                 probs: Optional[Dict[str, Union[float, Dict[str, float]]]]
                 = None,
                 trace: Sequence[FaultEvent] = (),
                 stall_ms: float = 250.0,
                 partial_frac: float = 0.5,
                 max_faults: Optional[int] = None):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.probs = dict(probs or {})
        self.trace = list(trace)
        self.stall_ms = float(stall_ms)
        self.partial_frac = float(partial_frac)
        self.max_faults = max_faults
        self.ops: Dict[str, int] = {}        # per-site op counter
        self.injected = 0

    def _scripted(self, site: str, n: int) -> Optional[FaultEvent]:
        for ev in self.trace:
            if ev.site == site and ev.after <= n < ev.after + ev.count:
                return ev
        return None

    def draw(self, site: str) -> Optional[FaultEvent]:
        """One op at `site`: returns the fault to inject, or None."""
        n = self.ops.get(site, 0)
        self.ops[site] = n + 1
        if self.max_faults is not None and self.injected >= self.max_faults:
            return None
        ev = self._scripted(site, n)
        if ev is None:
            spec = self.probs.get(site, self.probs.get("*"))
            if spec is not None:
                u = float(self._rng.random())
                kinds = ({"fail": float(spec)} if np.isscalar(spec)
                         else spec)
                acc = 0.0
                for kind in FAULT_KINDS:
                    p = float(kinds.get(kind, 0.0))
                    if p <= 0.0:
                        continue
                    acc += p
                    if u < acc:
                        ev = FaultEvent(site, kind,
                                        stall_ms=self.stall_ms,
                                        frac=self.partial_frac)
                        break
        if ev is not None:
            self.injected += 1
        return ev


class FaultInjector:
    """The engine-side handle: wraps an optional FaultPlan and keeps the
    injection counters (`fault_traffic()` surfaces them).  With no plan
    every call is a cheap no-op — the injector is always present so the
    chokepoints need no conditional wiring."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan
        self.counts: Dict[str, int] = {}        # "site/kind" -> n

    @property
    def armed(self) -> bool:
        return self.plan is not None

    def fire(self, site: str) -> Optional[FaultEvent]:
        if self.plan is None:
            return None
        ev = self.plan.draw(site)
        if ev is not None:
            k = f"{site}/{ev.kind}"
            self.counts[k] = self.counts.get(k, 0) + 1
        return ev

    def stall_s(self, site: str) -> float:
        """Fire `site`; return the injected stall in seconds (0.0 when
        no stall fired).  Non-stall kinds drawn at a stall-only site are
        ignored — used for the dispatch-deadline site where a failed
        'transfer' has no meaning."""
        ev = self.fire(site)
        if ev is not None and ev.kind == "stall":
            return ev.stall_ms * 1e-3
        return 0.0

    def total(self) -> int:
        return sum(self.counts.values())

    def raise_for(self, site: str) -> None:
        """Fire `site` and raise for the placement-probe chokepoint:
        there is no transfer to stall or partially complete, so every
        hard kind (fail/hostmem/exhaust) means the same thing — the
        allocation did not happen — and raises HostMemoryError."""
        ev = self.fire(site)
        if ev is None or ev.kind in ("stall", "partial"):
            return
        raise HostMemoryError(f"injected {ev.kind} @ {site}", site)


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------

LADDER_LEVELS: Tuple[str, ...] = (
    "healthy",            # 0: full pipeline
    "pageable_host",      # 1: pinned host tier demoted to pageable numpy
    "no_predict",         # 2: gate-predictor prefetch suspended
    "lockstep",           # 3: module windows clamped to lockstep (G=1)
    "residency_shrunk",   # 4: replica pins dropped, pool capacity halved
    "admission_shed",     # 5: scheduler sheds lowest-priority admissions
)


class DegradationLadder:
    """Reversible degradation state machine with hysteresis.

    ``note_fault`` / ``note_ok`` feed op outcomes (from the transfer
    engine and the dispatch watchdog); `down_after` consecutive faults
    move the *target* one rung down, `up_after` consecutive healthy ops
    one rung up (up_after > down_after is the hysteresis that stops
    flapping).  Side effects are applied only at `apply()` — the engine
    calls it at a safe point (start of each tick), crossing one rung at
    a time through an `enact(old, new, direction)` callback and
    emitting a structured event per transition.  `force_at_least`
    handles faults that cannot wait (a pinned-tier write that already
    failed): the engine demotes immediately and the ladder records the
    rung at the next apply."""

    def __init__(self, *, down_after: int = 3, up_after: int = 16,
                 max_level: int = len(LADDER_LEVELS) - 1):
        assert up_after > down_after > 0, "hysteresis needs up > down > 0"
        self.down_after = down_after
        self.up_after = up_after
        self.max_level = min(max_level, len(LADDER_LEVELS) - 1)
        self.level = 0
        self.target = 0
        self.events: List[dict] = []
        self.demotions = 0
        self.promotions = 0
        self._fault_streak = 0
        self._ok_streak = 0
        self._last_site = ""

    @property
    def level_name(self) -> str:
        return LADDER_LEVELS[self.level]

    def note_fault(self, site: str) -> None:
        self._last_site = site
        self._ok_streak = 0
        self._fault_streak += 1
        if self._fault_streak >= self.down_after \
                and self.target < self.max_level:
            self.target += 1
            self._fault_streak = 0

    def note_ok(self) -> None:
        self._fault_streak = 0
        self._ok_streak += 1
        if self._ok_streak >= self.up_after and self.target > 0:
            self.target -= 1
            self._ok_streak = 0

    def force_at_least(self, level_name: str, site: str = "") -> None:
        lvl = LADDER_LEVELS.index(level_name)
        if site:
            self._last_site = site
        self.target = max(self.target, min(lvl, self.max_level))

    def pending(self) -> bool:
        return self.target != self.level

    def apply(self, enact: Optional[Callable[[int, int, str], None]] = None,
              tick: int = 0) -> List[dict]:
        """Cross rungs one at a time toward the target; returns the
        transition events emitted (also appended to `self.events`)."""
        out: List[dict] = []
        while self.level != self.target:
            new = self.level + (1 if self.target > self.level else -1)
            direction = "down" if new > self.level else "up"
            # snapshot before enacting: a rung's side effect may itself
            # call force_at_least (tier demotion) and clobber the site
            reason = (self._last_site if direction == "down"
                      else "health_restored")
            if enact is not None:
                enact(self.level, new, direction)
            if direction == "down":
                self.demotions += 1
            else:
                self.promotions += 1
            ev = {"seq": len(self.events), "tick": tick,
                  "direction": direction,
                  "from": LADDER_LEVELS[self.level],
                  "to": LADDER_LEVELS[new],
                  "from_level": self.level, "to_level": new,
                  "reason": reason}
            self.level = new
            self.events.append(ev)
            out.append(ev)
        return out
