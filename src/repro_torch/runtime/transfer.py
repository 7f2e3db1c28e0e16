"""Retrying transfer engine: bounded retry + backoff + EWMA deadlines (a
copy of ``repro/runtime/transfer.py``).

Every mandatory H2D/D2H op the serving engine executes (BlockPool
spill/fetch plans, expert-span fills) runs through `TransferEngine`:

  * a `TransientTransferError` (injected by the fault plan, or raised by
    a real transport) is retried up to `max_retries` times with
    exponential backoff; an exhausted retry cycle books an **abort** and
    notifies the degradation ladder — and, for *mandatory* ops
    (`run_mandatory`), starts a fresh cycle, because a KV fetch or an
    admitted expert span must eventually land for correctness (dropping
    it would corrupt the cache the decode dispatch reads);
  * a `HostMemoryError` is never retried at the same tier: it propagates
    to the caller's `on_hostmem` hook (the engine demotes the pinned
    host tier to pageable there) and the op re-issues against the new
    tier;
  * each op's duration is scored against a per-site EWMA deadline
    (`runtime.watchdog.Watchdog.observe` — the training-loop straggler
    guard generalized to transfer ops).  Injected stalls add *virtual*
    seconds so chaos schedules stay deterministic without real sleeps; a
    deadline violation books a **stall** (and raises `StallTimeout`
    under ``stall_policy="abort"``).

Counters (retries / aborts / stalls / ok_ops / bytes) surface through
`Engine.fault_traffic()` in the same style as `weight_traffic()`.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from repro_torch.runtime.faults import (DegradationLadder, FaultInjector,
                                  HostMemoryError, StallTimeout,
                                  TransientTransferError)
from repro_torch.runtime.watchdog import Watchdog


class TransferEngine:
    def __init__(self, injector: Optional[FaultInjector] = None, *,
                 max_retries: int = 4, backoff_s: float = 0.0,
                 backoff_base: float = 2.0, sleep: bool = False,
                 deadline_factor: float = 8.0, min_deadline_s: float = 0.05,
                 stall_policy: str = "log",
                 ladder: Optional[DegradationLadder] = None):
        assert stall_policy in ("log", "abort")
        self.inj = injector or FaultInjector()
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_base = float(backoff_base)
        self.sleep = bool(sleep)         # real sleeps (prod); tests keep False
        self.deadline_factor = deadline_factor
        self.min_deadline_s = min_deadline_s
        self.stall_policy = stall_policy
        self.ladder = ladder
        self._deadlines: Dict[str, Watchdog] = {}
        self.retries = 0
        self.aborts = 0
        self.stalls = 0
        self.ok_ops = 0
        self.hostmem_faults = 0
        self.bytes_moved = 0

    # ----------------------------------------------------------- plumbing
    def _deadline(self, site: str) -> Watchdog:
        wd = self._deadlines.get(site)
        if wd is None:
            wd = Watchdog(deadline_factor=self.deadline_factor,
                          min_deadline_s=self.min_deadline_s, policy="log")
            self._deadlines[site] = wd
        return wd

    def _note_fault(self, site: str) -> None:
        if self.ladder is not None:
            self.ladder.note_fault(site)

    def _note_ok(self) -> None:
        if self.ladder is not None:
            self.ladder.note_ok()

    def book_retry(self, site: str) -> None:
        """External retry bookkeeping for chokepoints that retry in
        place instead of through run() (BlockPool ensure loops)."""
        self.retries += 1
        self._note_fault(site)

    def book_abort(self, site: str) -> None:
        self.aborts += 1
        self._note_fault(site)

    def book_stall(self, site: str) -> None:
        self.stalls += 1
        self._note_fault(site)

    def deadline_s(self, site: str) -> float:
        return self._deadline(site).deadline()

    # ---------------------------------------------------------- execution
    def run(self, site: str, fn: Callable, *, nbytes: int = 0):
        """Execute `fn` with bounded retry/backoff.  Raises
        `TransientTransferError` when the retry budget is exhausted
        (abort booked) and `HostMemoryError` immediately (no same-tier
        retry).  Successful ops are scored against the site's EWMA
        deadline; injected stalls charge virtual seconds."""
        delay = self.backoff_s
        attempt = 0
        while True:
            t0 = time.perf_counter()
            virt = 0.0
            try:
                ev = self.inj.fire(site)
                if ev is not None:
                    if ev.kind == "stall":
                        virt = ev.stall_ms * 1e-3
                        if self.sleep and virt > 0:
                            time.sleep(virt)
                    elif ev.kind == "hostmem":
                        raise HostMemoryError(
                            f"injected hostmem fault @ {site}", site)
                    else:
                        raise TransientTransferError(
                            f"injected {ev.kind} @ {site} "
                            f"(attempt {attempt})", site)
                out = fn()
            except HostMemoryError:
                self.hostmem_faults += 1
                self._note_fault(site)
                raise
            except TransientTransferError:
                self._note_fault(site)
                if attempt >= self.max_retries:
                    self.aborts += 1
                    raise
                self.retries += 1
                attempt += 1
                if self.sleep and delay > 0:
                    time.sleep(delay)
                delay = (delay or self.backoff_s) * self.backoff_base
                continue
            dt = time.perf_counter() - t0 + virt
            wd = self._deadline(site)
            if not wd.observe(dt):
                self.stalls += 1
                self._note_fault(site)
                if self.stall_policy == "abort":
                    raise StallTimeout(
                        f"{site} op took {dt:.3f}s > deadline "
                        f"{wd.deadline():.3f}s", site)
            else:
                self._note_ok()
            self.ok_ops += 1
            self.bytes_moved += int(nbytes)
            return out

    def run_mandatory(self, site: str, fn: Callable, *, nbytes: int = 0,
                      on_hostmem: Optional[Callable[[], None]] = None):
        """Run an op that MUST eventually complete (correctness, not
        advisory prefetch).  Exhausted retry cycles notify the ladder
        and start over — the fault plan is transient by construction
        (scripted bursts are finite, probabilistic draws have p < 1 or a
        max_faults bound), so this terminates.  `on_hostmem` handles a
        pinned-tier allocation failure (demote the tier) before the op
        re-issues."""
        while True:
            try:
                return self.run(site, fn, nbytes=nbytes)
            except TransientTransferError:
                continue          # abort already booked; fresh retry cycle
            except HostMemoryError:
                if on_hostmem is None:
                    raise
                on_hostmem()

    # ---------------------------------------------------------- reporting
    def stats(self) -> Dict[str, float]:
        return {
            "retries": self.retries,
            "aborts": self.aborts,
            "stalls": self.stalls,
            "ok_ops": self.ok_ops,
            "hostmem_faults": self.hostmem_faults,
            "bytes_moved": self.bytes_moved,
            "deadline_s": {s: wd.deadline()
                           for s, wd in self._deadlines.items()},
        }
