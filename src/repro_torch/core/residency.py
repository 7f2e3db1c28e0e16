"""Device-resident expert cache (control plane for expert-granular paging):
the port's own copy of ``repro/core/residency.py``, which is pure numpy.

The paper's policy tuple sizes a weight budget with ``r_w`` but the seed
paging layer streamed every layer's full page span regardless — all E
experts — even though top-k routing touches a fraction of them.  This
module turns ``r_w`` into an actual placement decision: a fixed device
page pool holds ``capacity`` expert spans (``slots_from_ratio`` converts
the policy ratio into a span count), an activation-popularity EWMA (the
``core.batching.GenLenEWMA`` pattern lifted to a (layer, expert) table)
decides which spans deserve the slots, and hit/miss + H2D-byte counters
make the traffic observable (the engine's ``weight_traffic()``).

Split of responsibilities:

  * data plane — PyTorch: the pool tensor and a device copy of the
    ``(layer, expert) → slot`` resident map are *arguments* to the serving
    steps; the expert gather kernel reads resident spans from the pool and
    misses straight from the pinned host store (models.moe.moe_paged);
  * control plane — this module, host-side numpy: which span occupies
    which slot, popularity, pins, counters.  The engine snapshots
    ``slot_of`` into the step call, so evicting *after* a chunk is
    dispatched can never corrupt it (the chunk holds its snapshot);
    pins additionally protect the spans an in-flight chunk may read so
    the router-ahead prefetch for the *next* group cannot recycle them.

Accounting model (the JAX package's, so the counters of both packages
agree; on the card the booked bytes are the ones the copies and the
gather move):

  * an activated expert whose span is resident is a **hit** (0 bytes);
  * an activated non-resident expert is a **miss** and streams its span
    inline (``span_bytes`` H2D).  Demand-admitting it into the pool in
    the same step reuses that stream (no second charge);
  * a **prefetch** admits a span before use and pays ``span_bytes`` up
    front; its later activation is then a hit.  Prefetch admissions
    carry a *cause* — ``router`` (group-j+1 router-ahead), ``predicted``
    (the cross-layer GatePredictor) or ``replica`` (hot-expert
    replication fill) — and hits are attributed back to the cause that
    staged the span, so the counters split demand / router / predicted /
    replicated hits and ``prefetch_accuracy`` (predicted-and-used /
    predicted) is measurable;
  * a miss whose span *landed during the dispatch it was consumed by*
    (the engine passes ``hidden_mask``) still pays its bytes but books
    as a **hidden miss**: its H2D stream overlapped the chunk's compute,
    so it contributes no stall — ``miss_stall_bytes`` accumulates the
    per-layer bytes of the *unhidden* misses only, which is exactly the
    per-layer miss-stall estimate the roofline report converts to time.

Replication: ``replicate_frac`` reserves a budget of the pool for
persistently-pinned replicas of the popularity-EWMA top spans.  Replicas
enter when they rank inside the budget (popularity ≥ the rank-budget
entry, θ_hi) and exit only when they decay below ``replica_exit · θ_hi``
(hysteresis), so they survive window turnover instead of churning with
it.  A replica is never an eviction victim and survives ``unpin_all``.

Prediction: ``GatePredictor`` — per-layer-transition logistic heads fit
online (plain numpy SGD, host control plane, no device work) on the
(chunk, L, E) activation counts the decode scan already emits, mapping
layer-i routed-token distributions to layer-i+1 activation
probabilities; chained once more for the i+2 lookahead.  Predicted
admissions are protected from demand-quota eviction for ``protect_ttl``
accounting rounds (or until first use), realizing "pinned in-flight so
demand misses never evict them".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Pair = Tuple[int, int]                       # (layer, expert)


def slots_from_ratio(w_gpu_ratio: float, num_layers: int,
                     num_experts: int) -> int:
    """Pool capacity (in expert spans) implied by the policy's ``r_w``:
    the fraction of all (layer, expert) spans that fits device-resident."""
    total = num_layers * num_experts
    return int(np.clip(round(w_gpu_ratio * total), 0, total))


@dataclass
class ResidencyCounters:
    hits: int = 0            # activated & resident (0 bytes)
    misses: int = 0          # activated & streamed inline (span_bytes)
    prefetches: int = 0      # admitted ahead of use (span_bytes)
    demand_admits: int = 0   # miss stream landed in a pool slot (no charge)
    evictions: int = 0
    refusals: int = 0        # admission declined (pinned/hotter cache)
    h2d_bytes: int = 0       # expert-span H2D traffic booked
    # what G separate per-group bookings would have charged: observe()
    # adds its own misses (lockstep IS per-group), observe_window() adds
    # the per-group miss count before the union dedup — the ratio
    # lockstep_misses / misses is the measured module-batching
    # amortization factor (weight_traffic()["module_groups_effective"])
    lockstep_misses: int = 0
    # hit attribution by the cause that staged the span (sums to hits):
    # demand-admitted / router-ahead prefetched / gate-predictor
    # prefetched / replicated.  A replica hit wins over the span's
    # original admission cause — the replication pin is what kept it
    # resident through window turnover.
    demand_hits: int = 0
    router_hits: int = 0
    predicted_hits: int = 0
    replicated_hits: int = 0
    # prefetch sub-causes (both also count in ``prefetches`` so the
    # h2d_bytes == span_bytes * (misses + prefetches) invariant holds)
    predicted_prefetches: int = 0   # gate-predictor admissions
    replications: int = 0          # replica fills copied into the pool
    predicted_used: int = 0        # predicted spans hit at least once
    # misses whose span landed during the very dispatch that consumed
    # them: bytes are charged but the H2D stream overlapped the chunk's
    # compute, so they contribute no stall (per-layer stall bytes live
    # on ExpertResidency.miss_stall_bytes)
    hidden_misses: int = 0

    @property
    def fetches(self) -> int:
        """Total activated-expert fetch events (hits + misses)."""
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.fetches if self.fetches else 0.0

    @property
    def stall_misses(self) -> int:
        """Misses whose stream could NOT hide behind the consuming
        dispatch's compute (the stall component of the expert phase)."""
        return self.misses - self.hidden_misses

    @property
    def prefetch_accuracy(self) -> float:
        """predicted-and-used / predicted — the gate predictor's realized
        precision (a wasted predicted span paid bytes for no hit)."""
        if self.predicted_prefetches == 0:
            return 0.0
        return self.predicted_used / self.predicted_prefetches


class ExpertResidency:
    """Fixed-capacity residency manager for one stacked layer group.

    Invariants:
      * occupancy ≤ capacity, and ``slot_of``/``owner`` stay a bijection
        between resident pairs and occupied slots;
      * a pinned span (in use by an in-flight chunk) is never evicted;
      * ``counters.fetches == hits + misses`` counts every activated
        expert fetch exactly once.
    """

    def __init__(self, num_layers: int, num_experts: int, *, capacity: int,
                 span_bytes: int, alpha: float = 0.25,
                 victim_quota: int = 0, replicate_frac: float = 0.0,
                 replica_exit: float = 0.5, replica_warmup: int = 8,
                 protect_ttl: int = 2):
        assert 0.0 < alpha <= 1.0
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.capacity = int(max(0, min(capacity, num_layers * num_experts)))
        self.span_bytes = span_bytes
        self.alpha = alpha
        # demand-path eviction allowance: misses normally fill free slots
        # only, but up to `victim_quota` demand admits per chunk may evict
        # a (strictly colder, unpinned) victim — so a cold cache under a
        # hot steady-state converges instead of refusing until the
        # prefetch path happens to agree (``begin_chunk`` refreshes it)
        self.victim_quota = int(max(0, victim_quota))
        self._victims_left = self.victim_quota
        # hot-expert replication: a replicate_frac share of the pool may
        # be pinned persistently to the popularity-EWMA top spans, with
        # enter/exit hysteresis (exit at replica_exit × the enter bar)
        self.replicate_frac = float(np.clip(replicate_frac, 0.0, 1.0))
        self.replica_exit = float(np.clip(replica_exit, 0.0, 1.0))
        self.replica_warmup = int(max(0, replica_warmup))
        self.protect_ttl = int(max(1, protect_ttl))
        self._chunks = 0              # accounting rounds seen (warmup gate)
        # degraded-mode occupancy cap (None = full capacity): set by the
        # engine's degradation ladder to shrink the pool reversibly —
        # admissions above the limit behave as if no slot were free, and
        # ``shrink_to_limit`` evicts cold spans down to it
        self.limit: Optional[int] = None
        self.slot_of = np.full((num_layers, num_experts), -1, np.int32)
        self.owner = np.full((self.capacity,), -1, np.int64)  # flat pair id
        self.free: List[int] = list(range(self.capacity))
        self.pinned: set = set()                              # flat pair ids
        self.replicas: set = set()            # flat pair ids, survive unpin
        # gate-predicted spans awaiting first use: pid → remaining
        # accounting rounds of eviction protection ("pinned in flight")
        self.protected: Dict[int, int] = {}
        self._pred_unused: set = set()        # predicted, not yet hit
        self.cause: Dict[int, str] = {}       # pid → admission cause
        self.popularity = np.zeros((num_layers, num_experts), np.float64)
        # per-layer unhidden-miss bytes — the roofline report's
        # miss-stall estimate (bytes / link bandwidth = stall time)
        self.miss_stall_bytes = np.zeros((num_layers,), np.int64)
        self.counters = ResidencyCounters()

    @property
    def replica_budget(self) -> int:
        return int(min(self.capacity,
                       round(self.replicate_frac * self.capacity)))

    # ------------------------------------------------------------- ids
    def _pid(self, layer: int, expert: int) -> int:
        return int(layer) * self.num_experts + int(expert)

    def _pair(self, pid: int) -> Pair:
        return divmod(int(pid), self.num_experts)

    # ---------------------------------------------------------- queries
    def is_resident(self, layer: int, expert: int) -> bool:
        return self.slot_of[layer, expert] >= 0

    def occupancy(self) -> int:
        return int((self.slot_of >= 0).sum())

    def resident_pairs(self) -> List[Pair]:
        return [self._pair(o) for o in self.owner if o >= 0]

    # ------------------------------------------------------------- pins
    def pin(self, pairs: Sequence[Pair]) -> None:
        """Protect spans an in-flight chunk may read in place: they cannot
        be evicted until ``unpin_all`` (called once the chunk's results
        are back on the host)."""
        self.pinned.update(self._pid(l, e) for l, e in pairs)

    def pin_resident(self) -> None:
        """Pin every currently-resident span: a dispatched chunk may read
        any of them in place, so none may be evicted until it lands."""
        self.pinned.update(int(o) for o in self.owner if o >= 0)

    def unpin_all(self) -> None:
        self.pinned.clear()

    def begin_chunk(self) -> None:
        """Refresh the per-chunk demand-eviction allowance (see
        ``victim_quota``) and age the predicted-span protection TTLs;
        the engine calls this once per accounting round."""
        self._victims_left = self.victim_quota
        self._chunks += 1
        for pid in [p for p, ttl in self.protected.items() if ttl <= 1]:
            del self.protected[pid]
        for pid in self.protected:
            self.protected[pid] -= 1

    # --------------------------------------------------- hit/miss booking
    def _book_hit(self, layer: int, expert: int) -> None:
        pid = self._pid(layer, expert)
        c = self.counters
        c.hits += 1
        if pid in self.replicas:
            c.replicated_hits += 1
        else:
            cause = self.cause.get(pid, "demand")
            if cause == "predicted":
                c.predicted_hits += 1
            elif cause == "router":
                c.router_hits += 1
            else:
                c.demand_hits += 1
        if pid in self._pred_unused:
            self._pred_unused.discard(pid)
            c.predicted_used += 1
        # first use releases the in-flight protection early
        self.protected.pop(pid, None)

    def _book_miss(self, layer: int, expert: int, hidden: bool) -> None:
        c = self.counters
        c.misses += 1
        c.h2d_bytes += self.span_bytes
        if hidden:
            c.hidden_misses += 1
        else:
            self.miss_stall_bytes[layer] += self.span_bytes

    # ----------------------------------------------- observe (accounting)
    def observe(self, activated: np.ndarray,
                token_counts: Optional[np.ndarray] = None,
                resident_mask: Optional[np.ndarray] = None,
                hidden_mask: Optional[np.ndarray] = None) -> List[Pair]:
        """Record one forward step's router decisions.

        activated: (L, E) bool — experts gated this step; token_counts
        optionally weights the popularity update by tokens routed.
        Updates the popularity EWMA, books hits / misses (+ inline H2D
        bytes for misses), and returns the missed pairs hottest-first —
        the admission candidates for the engine's prefetch queue.

        resident_mask: (L, E) bool snapshot of residency *at dispatch* of
        the step being booked — hits/misses must be judged against the
        map the step actually read, not the live one (prefetch/demand
        admissions may have landed since).

        hidden_mask: (L, E) bool — spans that became resident *between
        dispatch and landing* of this step (their stream overlapped its
        compute): such misses pay bytes but no per-layer stall."""
        activated = np.asarray(activated, bool)
        w = (np.asarray(token_counts, np.float64) if token_counts is not None
             else activated.astype(np.float64))
        denom = np.maximum(w.sum(axis=1, keepdims=True), 1.0)
        self.popularity += self.alpha * (w / denom - self.popularity)

        res = (np.asarray(resident_mask, bool) if resident_mask is not None
               else self.slot_of >= 0)
        hid = (np.asarray(hidden_mask, bool) if hidden_mask is not None
               else np.zeros_like(res))
        missed: List[Pair] = []
        for l, e in zip(*np.nonzero(activated)):
            if res[l, e]:
                self._book_hit(l, e)
            else:
                self._book_miss(l, e, bool(hid[l, e]))
                missed.append((int(l), int(e)))
        self.counters.lockstep_misses += len(missed)
        missed.sort(key=lambda p: -self.popularity[p])
        return missed

    def observe_window(self, activated: np.ndarray,
                       token_counts: Optional[np.ndarray] = None,
                       resident_mask: Optional[np.ndarray] = None,
                       hidden_mask: Optional[np.ndarray] = None
                       ) -> List[Pair]:
        """Book one module-batched accumulation window: `activated` is
        (G, L, E) — the G rotation groups that shared this forward step.
        An expert span streams at most ONCE per window regardless of how
        many groups routed to it, so hits/misses (and inline H2D bytes)
        are charged on the per-window UNION; ``lockstep_misses`` records
        what G separate ``observe`` calls would have charged, making the
        amortization measurable.  The popularity EWMA takes one update
        from the summed token weights (the window is one scheduling
        event, not G), and the returned admission candidates are the
        union misses hottest-first."""
        activated = np.asarray(activated, bool)
        assert activated.ndim == 3, "observe_window wants (G, L, E)"
        w = (np.asarray(token_counts, np.float64).sum(axis=0)
             if token_counts is not None
             else activated.astype(np.float64).sum(axis=0))
        denom = np.maximum(w.sum(axis=1, keepdims=True), 1.0)
        self.popularity += self.alpha * (w / denom - self.popularity)

        res = (np.asarray(resident_mask, bool) if resident_mask is not None
               else self.slot_of >= 0)
        hid = (np.asarray(hidden_mask, bool) if hidden_mask is not None
               else np.zeros_like(res))
        self.counters.lockstep_misses += int((activated & ~res[None]).sum())
        union = activated.any(axis=0)
        missed: List[Pair] = []
        for l, e in zip(*np.nonzero(union)):
            if res[l, e]:
                self._book_hit(l, e)
            else:
                self._book_miss(l, e, bool(hid[l, e]))
                missed.append((int(l), int(e)))
        missed.sort(key=lambda p: -self.popularity[p])
        return missed

    # ------------------------------------------------------- admit/evict
    def admit(self, layer: int, expert: int, *, demand: bool = False,
              allow_evict: bool = True, cause: Optional[str] = None,
              priority: Optional[float] = None) -> Optional[int]:
        """Grant (layer, expert) a pool slot; the caller must then copy
        the span into it.  Uses a free slot if any, else (when
        ``allow_evict``) evicts the coldest unpinned resident — only if
        it is strictly colder than the candidate (no thrash when the
        cache is already hotter), and never a pinned (in-flight) span, a
        replica, or a still-protected predicted span.
        Returns the slot id, or None when already resident / refused /
        capacity is zero.

        demand=True marks a miss stream landing directly in the pool (the
        bytes were already booked by ``observe``); otherwise this is a
        prefetch and pays ``span_bytes`` now.  ``cause`` labels the
        admission for hit attribution: "demand" (default when demand),
        "router" (default otherwise — the router-ahead group-j+1 path),
        "predicted" (gate-predictor lookahead; also grants
        ``protect_ttl`` rounds of eviction protection until first use)
        or "replica" (hot-expert replication fill).  The engine's demand
        path passes allow_evict=False — misses only fill free slots, and
        popularity-driven *replacement* is the prefetch path's job — so
        the two admission flows stay observable in the counters.
        Exception: up to ``victim_quota`` demand admits per chunk may
        evict anyway (same strictly-colder/unpinned rules), so a cold
        cache under a hot steady state converges faster.

        ``priority`` overrides the candidate's own popularity in the
        strictly-colder victim test: the popularity EWMA is a *long-run*
        frequency, but a gate-predicted span carries a *short-horizon*
        next-chunk activation probability — the engine passes
        score × predictor-accuracy so an imminent span can displace a
        stale tail resident the EWMA still ranks above it.  Replicas
        (the pinned long-run core) and protected spans are never
        victims, so the two signals occupy complementary slots."""
        if cause is None:
            cause = "demand" if demand else "router"
        if self.capacity == 0 or self.is_resident(layer, expert):
            return None
        # degraded-mode cap: at the limit a free slot is off-budget, so
        # admission must displace a victim (occupancy never grows)
        at_limit = (self.limit is not None
                    and self.occupancy() >= self.limit)
        use_quota = (not allow_evict and demand
                     and (not self.free or at_limit)
                     and self._victims_left > 0)
        if self.free and not at_limit:
            slot = self.free.pop()
        elif not allow_evict and not use_quota:
            self.counters.refusals += 1
            return None
        else:
            # o >= 0: with the degraded-mode cap the eviction branch can
            # run while free slots exist (they are off-budget, not victims)
            cands = [(self.popularity[self._pair(o)], s)
                     for s, o in enumerate(self.owner)
                     if o >= 0 and int(o) not in self.pinned
                     and int(o) not in self.replicas
                     and int(o) not in self.protected]
            if not cands:
                self.counters.refusals += 1
                return None
            vpop, slot = min(cands)
            cand_pri = (float(priority) if priority is not None
                        else self.popularity[layer, expert])
            if vpop >= cand_pri:
                self.counters.refusals += 1
                return None
            self.evict(slot)
            self.free.remove(slot)
            if use_quota:
                self._victims_left -= 1
        pid = self._pid(layer, expert)
        self.owner[slot] = pid
        self.slot_of[layer, expert] = slot
        self.cause[pid] = cause
        if demand:
            self.counters.demand_admits += 1
        else:
            self.counters.prefetches += 1
            self.counters.h2d_bytes += self.span_bytes
            if cause == "predicted":
                self.counters.predicted_prefetches += 1
                self._pred_unused.add(pid)
                self.protected[pid] = self.protect_ttl
            elif cause == "replica":
                self.counters.replications += 1
        return slot

    def evict(self, slot: int) -> None:
        pid = int(self.owner[slot])
        assert pid >= 0, f"evicting empty slot {slot}"
        assert pid not in self.pinned, \
            f"evicting pinned span {self._pair(pid)} (in-flight)"
        assert pid not in self.replicas, \
            f"evicting replicated span {self._pair(pid)}"
        self.slot_of[self._pair(pid)] = -1
        self.owner[slot] = -1
        self.free.append(slot)
        self.cause.pop(pid, None)
        self.protected.pop(pid, None)
        self._pred_unused.discard(pid)
        self.counters.evictions += 1

    # ----------------------------------------------- degraded-mode shrink
    def drop_replicas(self) -> int:
        """Release every persistent replica pin (the spans stay resident
        — they just become ordinary eviction candidates).  First step of
        the ladder's residency_shrunk rung."""
        n = len(self.replicas)
        self.replicas.clear()
        return n

    def set_limit(self, limit: Optional[int]) -> int:
        """Cap (or, with None, restore) the pool's usable occupancy.
        Returns the number of spans evicted to honor the new cap.
        Reversible by construction: residency only decides where bytes
        stream from, so shrinking never changes tokens."""
        self.limit = None if limit is None else int(max(1, limit))
        return self.shrink_to_limit()

    def shrink_to_limit(self) -> int:
        """Evict coldest-first down to ``limit``, skipping pinned
        (in-flight), replicated and still-protected spans — best effort:
        if pins block the full shrink, admission's at-limit rule keeps
        occupancy from growing and a later call finishes the job."""
        if self.limit is None:
            return 0
        evicted = 0
        while self.occupancy() > self.limit:
            cands = [(self.popularity[self._pair(o)], s)
                     for s, o in enumerate(self.owner)
                     if o >= 0 and int(o) not in self.pinned
                     and int(o) not in self.replicas
                     and int(o) not in self.protected]
            if not cands:
                break
            _, slot = min(cands)
            self.evict(slot)
            evicted += 1
        return evicted

    # ------------------------------------------------------- replication
    def update_replicas(self) -> List[Tuple[int, int, int]]:
        """Reconcile the replica set with the popularity EWMA, with
        hysteresis: a span enters when it ranks inside the
        ``replica_budget`` (popularity ≥ θ_hi, the rank-budget entry's
        popularity) and exits only when it decays below
        ``replica_exit · θ_hi`` — so replicas survive window turnover
        instead of churning with it.  Demoted replicas stay resident
        (they just lose the persistent pin); promoted spans that are not
        yet resident are admitted with cause="replica" (the caller must
        copy those spans — they are returned as (layer, expert, slot)).

        No-op for the first ``replica_warmup`` accounting rounds: the
        EWMA is still cold-start noise, and pinning the wrong spans
        early slows demand convergence more than replication helps."""
        if self.limit is not None:
            # degraded (residency_shrunk): replica pins stay dropped so
            # the shrunken pool keeps every slot evictable
            return []
        budget = self.replica_budget
        if budget <= 0:
            self.replicas.clear()
            return []
        if self._chunks < self.replica_warmup:
            return []
        pop = self.popularity.reshape(-1)
        order = np.argsort(-pop, kind="stable")
        top = [int(i) for i in order[:budget] if pop[i] > 0.0]
        if not top:
            return []
        theta_hi = float(pop[top[-1]])
        theta_lo = self.replica_exit * theta_hi
        for pid in [p for p in self.replicas if pop[p] < theta_lo]:
            self.replicas.discard(pid)
        copies: List[Tuple[int, int, int]] = []
        for pid in top:
            if len(self.replicas) >= budget:
                break
            if pid in self.replicas:
                continue
            l, e = self._pair(pid)
            if self.is_resident(l, e):
                self.replicas.add(pid)
                continue
            slot = self.admit(l, e, cause="replica")
            if slot is not None:
                self.replicas.add(pid)
                copies.append((l, e, slot))
        return copies


# ---------------------------------------------------------------------------
# Cross-layer gate prediction
# ---------------------------------------------------------------------------

def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30.0, 30.0)))


class GatePredictor:
    """Per-layer-transition logistic heads predicting layer-i+1 expert
    activations from layer-i routed-token counts.

    One head per transition: ``W[i]`` maps the normalized layer-i
    token-count vector (plus a bias feature) to per-expert activation
    logits for layer i+1.  Fit online with plain numpy SGD on the host
    control plane — one gradient step per forward pass per transition,
    on the (chunk, L, E) activation counts the decode scan already
    emits — so prediction costs no device work.

    The transition structure is cyclic in *time order*: heads
    0..L-2 map layer i to layer i+1 of the same forward pass, and the
    wrap head L-1 maps layer L-1 of pass t to layer 0 of pass t+1 — the
    temporal successor during decode (the scan finishes the stack, then
    the next pass re-enters layer 0).  The wrap head is what lets the
    predictor cover EVERY layer's next-pass activations, not just
    layers ≥ 1.

    ``acc`` is an EWMA of the *pre-update* top-k overlap between each
    head's prediction and the realized next-layer gating (k = realized
    activation breadth): the honest online accuracy estimate
    ``hrm.expert_hit_rate``'s predictor term consumes.
    """

    def __init__(self, num_layers: int, num_experts: int, *,
                 lr: float = 0.5, acc_alpha: float = 0.25,
                 wrap: bool = True):
        self.num_layers = int(num_layers)
        self.num_experts = int(num_experts)
        self.lr = float(lr)
        self.acc_alpha = float(acc_alpha)
        self.wrap = bool(wrap) and self.num_layers >= 1
        n_trans = max(0, self.num_layers - 1) + (1 if self.wrap else 0)
        # (transition, feature, expert); feature = E counts + 1 bias
        self.W = np.zeros((n_trans, self.num_experts + 1, self.num_experts),
                          np.float64)
        self.acc = 0.0
        self._n_fits = 0
        self._prev_top: Optional[np.ndarray] = None  # last pass's layer L-1

    def _feat(self, counts: np.ndarray) -> np.ndarray:
        x = np.asarray(counts, np.float64).reshape(-1)
        s = x.sum()
        if s > 0:
            x = x / s
        return np.concatenate([x, [1.0]])

    def fit_step(self, counts: np.ndarray) -> float:
        """One SGD step per layer transition on a single forward pass's
        (L, E) routed-token counts.  Scores each head's top-k prediction
        against the realized next layer BEFORE updating (honest online
        accuracy), folds the score into the EWMA, and returns it.

        The wrap head is fit on *consecutive calls*: the previous call's
        layer L-1 counts predict this call's layer 0.  Passes are fed in
        decode order per chunk, so within a chunk the pairing is exact;
        across chunk boundaries the stream may interleave rotation
        groups, which adds label noise the EWMA absorbs.
        """
        counts = np.asarray(counts, np.float64)
        if self.W.shape[0] == 0 or counts.sum() <= 0:
            return self.acc
        correct = 0
        total = 0
        for i in range(self.num_layers - 1):
            x = self._feat(counts[i])
            y = (counts[i + 1] > 0).astype(np.float64)
            k = int(y.sum())
            p = _sigmoid(x @ self.W[i])
            if k:
                top = np.argsort(-p, kind="stable")[:k]
                correct += int(y[top].sum())
                total += k
            self.W[i] += self.lr * np.outer(x, y - p)
        if self.wrap:
            prev = self._prev_top
            if prev is not None and prev.sum() > 0:
                wi = self.num_layers - 1
                x = self._feat(prev)
                y = (counts[0] > 0).astype(np.float64)
                k = int(y.sum())
                p = _sigmoid(x @ self.W[wi])
                if k:
                    top = np.argsort(-p, kind="stable")[:k]
                    correct += int(y[top].sum())
                    total += k
                self.W[wi] += self.lr * np.outer(x, y - p)
            self._prev_top = counts[self.num_layers - 1].copy()
        if total:
            score = correct / total
            self._n_fits += 1
            a = 1.0 if self._n_fits == 1 else self.acc_alpha
            self.acc += a * (score - self.acc)
        return self.acc

    def predict(self, counts: np.ndarray, *, lookahead: int = 2,
                topk: Optional[int] = None
                ) -> List[Tuple[int, int, float]]:
        """Score the experts the NEXT chunk will activate, per layer,
        from the last observed (L, E) counts: shift 1 maps layer i
        through head i to layer i+1; shift 2 chains the shift-1
        probabilities (as pseudo-counts) through the next head — the
        "stream layer i+2 while layer i computes" lookahead.  Per target
        layer, the top-k scores survive (k defaults to the source
        layer's realized activation breadth).  Returns
        [(layer, expert, score)] with each pair's best score over
        shifts."""
        counts = np.asarray(counts, np.float64)
        if self.W.shape[0] == 0 or counts.sum() <= 0 or lookahead <= 0:
            return []
        score = np.zeros((self.num_layers, self.num_experts), np.float64)
        cur = counts.astype(np.float64)
        n_src = self.num_layers if self.wrap else self.num_layers - 1
        for _shift in range(1, int(lookahead) + 1):
            nxt = np.zeros_like(cur)
            for i in range(n_src):
                src = cur[i]
                if src.sum() <= 0:
                    continue
                j = (i + 1) % self.num_layers
                p = _sigmoid(self._feat(src) @ self.W[i])
                k = (int(topk) if topk is not None
                     else int(min(self.num_experts,
                                  max(1, int((counts[i] > 0).sum())))))
                top = np.argsort(-p, kind="stable")[:k]
                sel = np.zeros(self.num_experts, np.float64)
                sel[top] = p[top]
                nxt[j] = np.maximum(nxt[j], sel)
                score[j] = np.maximum(score[j], sel)
            cur = nxt
            if cur.sum() <= 0:
                break
        return [(int(l), int(e), float(score[l, e]))
                for l, e in zip(*np.nonzero(score > 0.0))]
