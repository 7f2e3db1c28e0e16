"""Request scheduler of the continuous-batching slot-pool engine: a FCFS
queue, per-slot lifecycle tracking, and admission of single requests into
freed slots via the paper's Algorithm 2 balance criterion
(core.batching.place_request).

The continuous subset of ``repro/serving/scheduler.py``: every live request
reserves its full remaining quota, so admission alone keeps a group's KV
footprint within its slice of the pool.  With the block-paged KV pool
(``block_tokens`` set) every charge rounds up to whole blocks, and the
engine may preempt a request when the shared arena overflows: its slot is
freed and the request re-queued at its FCFS position with its transcript
intact; re-admission prefills prompt + generated-so-far (recompute
preemption), so greedy output is unchanged.  Batch admission (static mode),
EOS-aware reservations and degraded-mode shedding are later slices.

Slot lifecycle: FREE → PREFILL → DECODE → FREE.  A slot is one batch row of
one rotation group's pooled KV cache; `Slot.history` records every request
id the slot has served (slot recycling is observable).  `Slot.prefill_pos`
is the staged-admission sub-state: how many prompt tokens overlapped
admission has chunk-prefilled so far.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.batching import place_request, round_to_blocks


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False
    aborted: bool = False
    preemptions: int = 0             # times evicted + re-queued

    @property
    def input_len(self) -> int:
        return len(self.prompt)

    @property
    def effective_prompt(self) -> np.ndarray:
        """What (re-)admission must prefill: the prompt plus everything
        generated before a preemption.  Greedy re-prefill of this prefix
        reproduces the request's continuation exactly (the final-position
        logits are the logits that produced the next token)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def footprint(self) -> int:
        """KV tokens this request occupies once its pending token lands:
        prompt + generated so far (invariant across preemptions)."""
        return self.input_len + len(self.generated)

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


class SlotState(enum.Enum):
    FREE = "free"
    PREFILL = "prefilling"
    DECODE = "decoding"


@dataclass
class Slot:
    gid: int                          # rotation group (micro-batch) index
    row: int                          # batch row within the group's cache
    state: SlotState = SlotState.FREE
    req: Optional[ServeRequest] = None
    history: List[int] = field(default_factory=list)   # rids served
    prefill_pos: int = 0              # prompt tokens chunk-prefilled so far


class Scheduler:
    def __init__(self, *, ubatch: int, num_ubs: int, max_seq: int,
                 block_tokens: Optional[int] = None):
        self.ubatch = ubatch
        self.num_ubs = num_ubs
        self.max_seq = max_seq
        # per-group KV budget: the group's physical slice of the pool
        self.cache_tokens = max_seq * ubatch
        # block-granular paged KV: a request occupies whole arena blocks,
        # so every budget charge rounds up to the block boundary (None =
        # dense max_seq-wide pool, token-exact accounting)
        self.block_tokens = block_tokens
        self._rid = itertools.count()
        self.queue: List[ServeRequest] = []
        self.requests: Dict[int, ServeRequest] = {}
        self.slots: List[List[Slot]] = [
            [Slot(g, r) for r in range(ubatch)] for g in range(num_ubs)]

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        rid = next(self._rid)
        req = ServeRequest(rid, np.asarray(prompt, np.int32), max_new_tokens)
        self.requests[rid] = req
        if req.input_len + max_new_tokens > self.max_seq:
            # prompt + generation must fit the per-slot ring width: a longer
            # prompt crashes at prefill, and generation past the ring wraps
            # it and silently evicts the earliest context
            req.aborted = True
            req.done = True
        else:
            self.queue.append(req)
        return rid

    def _charge(self, tokens: int) -> int:
        """Budget charge of a footprint: block-rounded when the paged
        arena is in play (whole blocks are occupied), exact otherwise."""
        return round_to_blocks(tokens, self.block_tokens)

    def group_load(self, gid: int) -> Tuple[int, int]:
        """(charge of token footprint + remaining quota over occupied
        slots, live request count)."""
        toks = cnt = 0
        for s in self.slots[gid]:
            if s.state in (SlotState.PREFILL, SlotState.DECODE) and s.req:
                toks += self._charge(s.req.footprint + s.req.remaining)
                cnt += 1
        return toks, cnt

    def admit_to_slots(self) -> List[Slot]:
        """FCFS continuous admission: place queued requests into free slots
        using Algorithm 2's balance criterion with per-request reservations
        of the exact remaining quota.  Marks chosen slots PREFILL and
        returns them; the engine prefills and flips them to DECODE."""
        assigned: List[Slot] = []
        while self.queue:
            req = self.queue[0]
            loads = [self.group_load(g) for g in range(self.num_ubs)]
            open_mask = [any(s.state == SlotState.FREE for s in grp)
                         for grp in self.slots]
            gid = place_request(
                self._charge(req.footprint + req.remaining),
                [t for t, _ in loads],
                [c for _, c in loads], gen_len=0, reserve=0,
                cache_size=self.cache_tokens, open_mask=open_mask)
            if gid is None:
                break                      # wait for a slot/budget to free
            slot = next(s for s in self.slots[gid]
                        if s.state == SlotState.FREE)
            self.queue.pop(0)
            slot.req = req
            slot.state = SlotState.PREFILL
            slot.history.append(req.rid)
            assigned.append(slot)
        return assigned

    def start_decode(self, slot: Slot) -> None:
        assert slot.state == SlotState.PREFILL
        slot.state = SlotState.DECODE

    def prefill_progress(self, slot: Slot, n_tokens: int) -> None:
        """Record that `n_tokens` more prompt tokens of the staged
        admission have been chunk-prefilled into the slot's cache row."""
        assert slot.state == SlotState.PREFILL
        slot.prefill_pos += n_tokens

    def preempt(self, slot: Slot) -> None:
        """Evict a decoding request: free its slot and re-queue it at its
        FCFS position (every queued request was submitted later than any
        admitted one, so ordering by rid restores first-come order)."""
        assert slot.state == SlotState.DECODE and slot.req is not None
        req = slot.req
        req.preemptions += 1
        self.release(slot)
        i = 0
        while i < len(self.queue) and self.queue[i].rid < req.rid:
            i += 1
        self.queue.insert(i, req)

    def release(self, slot: Slot) -> None:
        """Slot re-enters the free pool; its cache row stays masked until
        the next admission's slot-insert fully overwrites it."""
        slot.state = SlotState.FREE
        slot.req = None
        slot.prefill_pos = 0

    def finish(self, slot: Slot) -> None:
        """Request completed (quota met or EOS): mark it done and return
        the slot to the free pool."""
        assert slot.state in (SlotState.PREFILL, SlotState.DECODE)
        slot.req.done = True
        self.release(slot)

    def has_live_slots(self) -> bool:
        return any(s.state in (SlotState.PREFILL, SlotState.DECODE)
                   for grp in self.slots for s in grp)
