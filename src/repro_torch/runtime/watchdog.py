"""Watchdog: heartbeat + straggler detection (a copy of
``repro/runtime/watchdog.py``).

A straggler — a step or op past its deadline (EWMA × factor) — is
answered per policy:

  "log"   — record and continue (default),
  "skip"  — abandon the step's data (re-dispatched next step),
  "abort" — raise.

The serving engine scores each decode dispatch with one (``step_start`` /
``step_end``), and the transfer engine each op per site (``observe``).
The heartbeat file (``heartbeat_path``) lets a peer process check that this
one is alive.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


class StragglerError(RuntimeError):
    pass


@dataclass
class Watchdog:
    deadline_factor: float = 3.0
    min_deadline_s: float = 1.0
    policy: str = "log"                  # log | skip | abort
    heartbeat_path: Optional[str] = None
    ewma: float = 0.0
    alpha: float = 0.1
    slow_steps: int = 0
    steps_seen: int = 0
    _t0: float = field(default=0.0, repr=False)

    def deadline(self) -> float:
        return max(self.min_deadline_s, self.deadline_factor * self.ewma)

    def step_start(self):
        self._t0 = time.monotonic()
        self.beat()

    def step_end(self, extra_s: float = 0.0) -> bool:
        """Returns True if the step was within deadline.  ``extra_s``
        adds virtual latency (injected stalls) so fault schedules stay
        deterministic without real sleeps."""
        return self.observe(time.monotonic() - self._t0 + extra_s)

    def observe(self, dt: float) -> bool:
        """Score one step/op duration against the EWMA deadline.  Split
        from step_end so callers that measure their own durations (the
        transfer engine's per-site deadlines) share the policy logic.

        The EWMA is seeded by the first observed sample (by step count,
        not by value — a 0.0-duration first step must not re-seed
        forever) and updated on EVERY step with a deadline-clipped
        sample, *including* steps that violate the deadline — before the
        abort policy raises — so one straggler neither poisons nor
        freezes the deadline estimate."""
        if self.steps_seen == 0:
            self.ewma = dt
        deadline = self.deadline()
        ok = dt <= deadline
        self.ewma = (1 - self.alpha) * self.ewma \
            + self.alpha * min(dt, deadline)
        self.steps_seen += 1
        if not ok:
            self.slow_steps += 1
            if self.policy == "abort":
                raise StragglerError(
                    f"step took {dt:.2f}s > deadline {deadline:.2f}s")
        return ok

    def beat(self):
        if self.heartbeat_path:
            Path(self.heartbeat_path).write_text(
                json.dumps({"t": time.time()}))

    @staticmethod
    def peer_alive(heartbeat_path: str, timeout_s: float = 60.0) -> bool:
        p = Path(heartbeat_path)
        if not p.exists():
            return False
        t = json.loads(p.read_text())["t"]
        return (time.time() - t) < timeout_s
