"""Request scheduler of the slot-pool engine: a FCFS queue, admission via
the paper's Algorithm 2, and per-slot lifecycle tracking.

A copy of ``repro/serving/scheduler.py``.  Two admission modes:

  * batch (``admit``): Algorithm 2 over the whole queue — μ-sized
    micro-batches with balanced token counts under the KV budget, each
    request reserving the uniform ``gen_len`` (static engine mode);
  * incremental (``admit_to_slots``): FCFS placement of single requests
    into freed slots via Algorithm 2's balance criterion
    (core.batching.place_request), used by the continuous engine.

Each rotation group has a KV budget of ``cache_tokens`` (the engine passes
its physical slice of the pool, ``max_seq × ubatch``, unless a tighter
one, e.g. from the HRM policy, is set).  A prompt whose prompt +
generation exceeds ``max_input_len`` (the ring width) is rejected at
``submit``, or with ``on_long_prompt="truncate"`` trimmed to
``max_input_len - max_new_tokens`` tokens.  Reservation policy of
incremental admission, ``reserve_mode``:

  * ``"worst"`` — every live request reserves its full remaining quota, so
    admission alone keeps a group's KV footprint within ``cache_tokens``.
  * ``"ewma"`` — EOS-aware: live requests reserve the *expected* remaining
    generation length, from a running EWMA of observed generation lengths
    (core.batching.GenLenEWMA).  Admission is optimistic, so the engine
    calls ``enforce_budget`` before each decode chunk; when the optimism
    was wrong, the group's youngest decoding request is preempted.

With the block-paged KV pool (``block_tokens`` set) every charge rounds up
to whole blocks, and the engine may also preempt a request when the shared
arena overflows.  A preempted request's slot is freed and the request
re-queued at its FCFS position with its transcript intact; re-admission
prefills prompt + generated-so-far (recompute preemption), so greedy output
is unchanged.

Degraded-mode shedding (the degradation ladder's bottom rung,
``runtime.faults``): while ``shed_priority`` is set, new work whose
``priority`` is at least it is rejected at submit and at admission (marked
``shed``, aborted, never generated); a preempted request, which has a
transcript, is never shed.

Slot lifecycle: FREE → PREFILL → DECODE → FREE.  A slot is one batch row
of one rotation group's pooled KV cache; `Slot.history` records every
request id the slot has served (slot recycling is observable).
`Slot.prefill_pos` is the staged-admission sub-state: how many prompt
tokens overlapped admission has chunk-prefilled so far.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.batching import (GenLenEWMA, Request,
                                       batch_requests, place_request,
                                       round_to_blocks)


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False
    aborted: bool = False
    preemptions: int = 0             # times evicted + re-queued
    priority: int = 0                # 0 = most important; higher = shed first
    shed: bool = False               # aborted by degraded-mode backpressure

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
    def __init__(self, *, ubatch: int, num_ubs: int, cache_tokens: int,
                 gen_len: int, max_input_len: Optional[int] = None,
                 on_long_prompt: str = "reject",
                 reserve_mode: str = "worst", ewma_alpha: float = 0.25,
                 block_tokens: Optional[int] = None):
        self.ubatch = ubatch
        self.num_ubs = num_ubs
        self.cache_tokens = cache_tokens
        self.gen_len = gen_len
        self.max_input_len = max_input_len
        # block-granular paged KV: a request occupies whole arena blocks,
        # so every budget charge rounds up to the block boundary (None =
        # dense max_seq-wide pool, token-exact accounting)
        self.block_tokens = block_tokens
        assert on_long_prompt in ("reject", "truncate")
        self.on_long_prompt = on_long_prompt
        assert reserve_mode in ("worst", "ewma")
        self.reserve_mode = reserve_mode
        # degraded-mode backpressure (the ladder's admission_shed rung):
        # when set, NEW work with priority >= shed_priority is rejected at
        # admission — load already admitted keeps its slots, so shedding
        # never perturbs in-flight transcripts
        self.shed_priority: Optional[int] = None
        self.shed_count = 0
        self.gen_ewma = GenLenEWMA(ewma_alpha)
        self._rid = itertools.count()
        self.queue: List[ServeRequest] = []
        self.requests: Dict[int, ServeRequest] = {}
        self.slots: List[List[Slot]] = [
            [Slot(g, r) for r in range(ubatch)] for g in range(num_ubs)]

    def _shed(self, req: ServeRequest) -> bool:
        """Degraded-mode backpressure: reject the lowest-priority new
        work while the ladder sits at admission_shed."""
        if self.shed_priority is None or req.priority < self.shed_priority:
            return False
        req.aborted = True
        req.done = True
        req.shed = True
        self.shed_count += 1
        return True

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               priority: int = 0) -> int:
        rid = next(self._rid)
        prompt = np.asarray(prompt, np.int32)
        req = ServeRequest(rid, prompt, max_new_tokens, priority=priority)
        self.requests[rid] = req
        if self._shed(req):
            return rid
        if self.max_input_len is not None and \
                len(prompt) + max_new_tokens > self.max_input_len:
            # prompt + generation must fit the per-slot ring width: a longer
            # prompt crashes at prefill, and generation past the ring wraps
            # it and silently evicts the earliest context
            keep = self.max_input_len - max_new_tokens
            if self.on_long_prompt == "truncate" and keep >= 1:
                req.prompt = prompt[:keep]
            else:
                req.aborted = True
                req.done = True
                return rid
        self.queue.append(req)
        return rid

    def admit(self, max_groups: Optional[int] = None
              ) -> List[List[ServeRequest]]:
        """Run Algorithm 2 over the current queue; returns micro-batches
        of ServeRequests (≤ max_groups ≤ num_ubs batches of ≤ ubatch
        requests).
        `max_groups` lets the engine cap admission to the rotation capacity
        it has free, keeping the KV pool at its fixed budget."""
        cap = self.num_ubs if max_groups is None \
            else min(max_groups, self.num_ubs)
        if not self.queue or cap <= 0:
            return []
        if self.shed_priority is not None:
            # degraded-mode shed (same rule as admit_to_slots): only new
            # work that has not generated anything is sheddable
            self.queue = [r for r in self.queue
                          if r.generated or not self._shed(r)]
        algo_reqs = [Request(r.rid, r.input_len, r.max_new_tokens)
                     for r in self.queue]
        mbs, aborted = batch_requests(algo_reqs, self.num_ubs, self.ubatch,
                                      self.gen_len, self.cache_tokens)
        aborted_ids = set()
        for r in aborted:
            if r.input_len + self.gen_len > self.cache_tokens:
                # cannot fit even an empty partition under Algorithm 2's
                # uniform gen_len reservation, so batch mode can never
                # place it: abort permanently instead of re-queueing it
                # forever (continuous mode reserves per-request quotas
                # instead and would admit some of these)
                req = self.requests[r.rid]
                req.aborted = True
                req.done = True
            else:
                aborted_ids.add(r.rid)         # deferred to a later round
        admitted: List[List[ServeRequest]] = []
        for mb in mbs[:cap]:
            admitted.append([self.requests[r.rid] for r in mb.requests])
        admitted_ids = {r.rid for g in admitted for r in g}
        self.queue = [r for r in self.queue
                      if not r.aborted and (r.rid in aborted_ids
                                            or r.rid not in admitted_ids)]
        return admitted

    def _reserve(self, req: ServeRequest) -> int:
        """Generation tokens reserved for a live (or candidate) request
        beyond its current footprint: full remaining quota in "worst"
        mode, EWMA-expected remaining (≥ 1, ≤ quota) in "ewma" mode."""
        worst = req.remaining
        if self.reserve_mode == "worst":
            return worst
        expected = self.gen_ewma.expected(req.max_new_tokens)
        return max(1, min(worst, expected - len(req.generated)))

    def _charge(self, tokens: int) -> int:
        """Budget charge of a footprint: block-rounded when the paged
        arena is in play (whole blocks are occupied), exact otherwise."""
        return round_to_blocks(tokens, self.block_tokens)

    def group_load(self, gid: int) -> Tuple[int, int]:
        """(charge of token footprint + reservation over occupied slots,
        live request count).  Footprints are actual (prompt + generated so
        far); reservations follow reserve_mode — so under "ewma" the load
        of a long-running request grows as it outlives the estimate."""
        toks = cnt = 0
        for s in self.slots[gid]:
            if s.state in (SlotState.PREFILL, SlotState.DECODE) and s.req:
                toks += self._charge(s.req.footprint + self._reserve(s.req))
                cnt += 1
        return toks, cnt

    def admit_to_slots(self) -> List[Slot]:
        """FCFS continuous admission: place queued requests into free slots
        using Algorithm 2's balance criterion with per-request reservations
        (the exact remaining quota, or the EWMA expectation in "ewma"
        mode).  A request that would not fit an empty group even at its
        worst case, or whose transcript would outgrow ``max_input_len``,
        is aborted (preemption cannot shrink a lone request; the ring
        bound is normally enforced at submit, and re-checking it here
        keeps recompute preemption safe for callers that skipped it).
        Marks chosen slots PREFILL and returns them; the engine prefills
        and flips them to DECODE."""
        assigned: List[Slot] = []
        while self.queue:
            req = self.queue[0]
            # degraded-mode shed: reject queued low-priority work that has
            # not started (never a preempted request — its partial
            # transcript must survive re-admission untouched)
            if self.shed_priority is not None and not req.generated \
                    and self._shed(req):
                self.queue.pop(0)
                continue
            worst = req.footprint + req.remaining
            if self._charge(worst) > self.cache_tokens or \
                    (self.max_input_len is not None
                     and worst > self.max_input_len):
                self.queue.pop(0)
                req.aborted = True
                req.done = True
                continue
            loads = [self.group_load(g) for g in range(self.num_ubs)]
            open_mask = [any(s.state == SlotState.FREE for s in grp)
                         for grp in self.slots]
            # the candidate's whole-block charge rides in as input_len
            # (reservation folded in) so paged admission books arena blocks
            gid = place_request(
                self._charge(req.footprint + self._reserve(req)),
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

    def enforce_budget(self, gid: int, chunk: int,
                       prefill_chunk: Optional[int] = None
                       ) -> List[ServeRequest]:
        """Pre-decode guard for optimistic ("ewma") reservations: ensure
        the group's footprint cannot exceed cache_tokens even if every
        decoding row emits its next `chunk` tokens and every staged
        prefill that its next chunk of `prefill_chunk` prompt tokens
        completes emits its first token (None: any staged prefill may
        complete).  While it could, preempt the youngest decoding request.
        Returns the preempted requests.  Under "worst" reservations
        admission already guarantees the bound and this is a no-op.

        The JAX package charges a staged prefill its footprint alone, so
        a first token that lands before the next guard can take the group
        one token over its budget; this guard is a deliberate deviation
        from it."""
        preempted: List[ServeRequest] = []
        while True:
            live = [s for s in self.slots[gid]
                    if s.state in (SlotState.PREFILL, SlotState.DECODE)
                    and s.req]
            decoding = [s for s in live if s.state == SlotState.DECODE]
            occ_need = sum(
                self._charge(s.req.footprint + self._next_tokens(
                    s, chunk, prefill_chunk)) for s in live)
            if occ_need <= self.cache_tokens or not decoding:
                return preempted
            victim = max(decoding, key=lambda s: s.req.rid)   # youngest
            preempted.append(victim.req)
            self.preempt(victim)

    @staticmethod
    def _next_tokens(slot: Slot, chunk: int,
                     prefill_chunk: Optional[int]) -> int:
        """Tokens a live slot may add before the next guard: a decoding
        row its next chunk, a staged prefill its first token once its
        next prefill chunk reaches the end of its prompt."""
        if slot.state == SlotState.DECODE:
            return min(chunk, slot.req.remaining)
        rest = slot.req.footprint - slot.prefill_pos      # prompt left
        return int(prefill_chunk is None or rest <= prefill_chunk)

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
        """Request completed (quota met or EOS): mark it done, feed the
        generation-length EWMA and return the slot to the free pool."""
        assert slot.state in (SlotState.PREFILL, SlotState.DECODE)
        slot.req.done = True
        self.gen_ewma.observe(len(slot.req.generated))
        self.release(slot)

    def has_live_slots(self) -> bool:
        return any(s.state in (SlotState.PREFILL, SlotState.DECODE)
                   for grp in self.slots for s in grp)
