"""Block-granular KV page-table control plane (host side).

The paper's policy tuple places a fraction ``r_c`` of the KV cache on
GPU (Table 1) and keeps the remainder CPU-resident, but the serving
stack used to allocate one dense ``max_seq``-wide KV ring per slot,
entirely on device — ``r_c`` existed only inside ``core.policy``'s
arithmetic.  This module is the KV analogue of ``core.residency``: the
control plane for a **shared arena** of fixed-size token blocks
(``block_tokens`` ring slots each) plus a
``(slot, logical_block) → physical_block`` page table, so a request's
device KV footprint is proportional to its actual length instead of
``max_seq``, and cold blocks can be demoted to a host-RAM block store
sized by the rest of the budget.

Split of responsibilities (mirrors ``core.residency``):

  * data plane — PyTorch (``repro_torch.models.kvcache``): the arena
    tensors and a device page-table snapshot ride in the cache dict of
    each dispatch; decode attention reads K/V straight through the page
    table under the existing ``slot_pos`` masking, so greedy transcripts
    are bit-identical in every tier regime;
  * control plane — this module, host-side numpy: which physical block
    holds which (slot, logical_block), which blocks live in the host
    tier, victim selection, hit/miss/spill counters.  Methods *plan*
    data movement (ordered op lists) and the engine executes the copies,
    so the map can never disagree with what actually moved.

Placement states per (slot, logical_block):

  * **unmapped** — no KV written there yet (device and host entry -1);
  * **device**   — resident in the physical arena (device entry = id);
  * **host**     — spilled to the host-RAM block store; streams back
    through ``paging.transfer_plan`` rotation slices (prefetch) or on
    demand at dispatch preparation (a **miss**, H2D ``block_bytes``).

Accounting model (the engine performs every planned copy, so the byte
counters are what crossed between the arena and the host tier):

  * every block a decode chunk's attention will read is a **fetch
    event** at dispatch preparation: device-resident → **hit** (0
    bytes), host-resident → **miss** (streams back inline, H2D);
  * a **prefetch** promotes a host block ahead of its group's turn
    (free arena blocks only) and pays H2D up front; the later touch is
    then a hit;
  * a **spill** demotes a victim block to the host tier (D2H) to make
    room; protected slots (the group being dispatched / the staged
    prefill target) are never victims — the paged-attention analogue of
    residency's pinned spans.

Invariants (``check_invariants``, run after every step by the tests):

  * free-list conservation: every device/host block id is either free or
    owned by exactly one (slot, logical_block), exactly once;
  * no double mapping: a logical block is device- xor host-resident;
  * a slot's mapped logical blocks form a contiguous prefix (KV is
    append-only: prompt blocks, then decode growth);
  * ``counters.fetches == hits + misses`` counts every planned block
    read exactly once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batching import blocks_for_tokens

# Ordered data-movement instructions for the engine to execute:
#   ("spill", slot, lb, pb, hb)  copy arena block pb -> host block hb
#   ("fetch", slot, lb, hb, pb)  copy host block hb -> arena block pb
#   ("alloc", slot, lb, pb)      fresh block: clear arena slot_pos[pb]
Op = Tuple


@dataclass
class BlockCounters:
    hits: int = 0            # touched & device-resident (0 bytes)
    misses: int = 0          # touched & streamed back inline (block_bytes)
    prefetches: int = 0      # promoted ahead of use (block_bytes)
    spills: int = 0          # demoted to the host tier (block_bytes D2H)
    allocs: int = 0          # fresh blocks mapped
    frees: int = 0           # blocks released (slot drained / preempted)
    h2d_bytes: int = 0
    d2h_bytes: int = 0

    @property
    def fetches(self) -> int:
        """Total planned block-read events (hits + misses)."""
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.fetches if self.fetches else 0.0


class BlockPool:
    """Page-table manager for one shared KV block arena (a copy of
    ``repro/core/blockpool.py``'s).

    ``n_slots`` rows (the engine's ``num_ubs × ubatch`` slot pool, plus
    static-mode micro-batches mapped onto the same indices) of
    ``blocks_per_slot`` logical blocks each, backed by ``device_blocks``
    physical arena blocks and an (always sufficient) host block store.
    ``block_bytes`` is what one block transfer moves across every paged
    layer group — the unit of the H2D/D2H counters.
    """

    def __init__(self, n_slots: int, blocks_per_slot: int,
                 device_blocks: int, block_bytes: int, faults=None):
        assert device_blocks >= 1 and blocks_per_slot >= 1
        self.n_slots = n_slots
        self.blocks_per_slot = blocks_per_slot
        self.device_blocks = device_blocks
        self.block_bytes = block_bytes
        # optional runtime.faults.FaultInjector: the "kv_pool" site models
        # arena exhaustion — ensure_range refuses at entry as if no block
        # could be acquired, and flags the refusal so the engine can retry
        # (injected exhaustion is transient) instead of preempting
        self.faults = faults
        self.last_refusal_injected = False
        host_blocks = n_slots * blocks_per_slot   # worst case: all spilled
        self.dev = np.full((n_slots, blocks_per_slot), -1, np.int32)
        self.host = np.full((n_slots, blocks_per_slot), -1, np.int32)
        self.free_dev: List[int] = list(range(device_blocks))
        self.free_host: List[int] = list(range(host_blocks))
        self.dev_owner = np.full((device_blocks,), -1, np.int64)
        self.host_owner = np.full((host_blocks,), -1, np.int64)
        self.last_touch = np.zeros((n_slots,), np.int64)
        self._tick = 0
        self.peak_in_use = 0
        self.counters = BlockCounters()

    # ------------------------------------------------------------- ids
    def _pid(self, slot: int, lb: int) -> int:
        return int(slot) * self.blocks_per_slot + int(lb)

    def _pair(self, pid: int) -> Tuple[int, int]:
        return divmod(int(pid), self.blocks_per_slot)

    # ---------------------------------------------------------- queries
    def n_mapped(self, slot: int) -> int:
        """Length of the slot's mapped logical-block prefix."""
        mapped = (self.dev[slot] >= 0) | (self.host[slot] >= 0)
        return int(mapped.sum())

    def slot_in_use(self, slot: int) -> bool:
        return self.n_mapped(slot) > 0

    def in_use_device(self) -> int:
        return self.device_blocks - len(self.free_dev)

    def device_table(self, rows: Sequence[int]) -> np.ndarray:
        """The (B, blocks_per_slot) device page table the jitted step
        reads: physical block id, or -1 (unmapped OR host-resident —
        either way the gather masks that span)."""
        return self.dev[np.asarray(rows, np.int64)].astype(np.int32)

    def host_resident_blocks(self, slot: int) -> List[int]:
        return np.flatnonzero(self.host[slot] >= 0).tolist()

    # -------------------------------------------------- device acquire
    def _spill_one(self, protect: frozenset) -> Optional[Op]:
        """Demote one victim block: slots outside ``protect``, least
        recently touched first; within a slot, oldest (lowest logical)
        block first.  Window-layer rings never enter the arena, so they
        are exempt by construction."""
        cands = [s for s in range(self.n_slots)
                 if s not in protect and (self.dev[s] >= 0).any()]
        if not cands:
            return None
        s = min(cands, key=lambda x: (self.last_touch[x], x))
        lb = int(np.flatnonzero(self.dev[s] >= 0)[0])     # oldest first
        pb = int(self.dev[s, lb])
        if not self.free_host:
            return None                                    # store exhausted
        hb = self.free_host.pop()
        self.dev[s, lb] = -1
        self.dev_owner[pb] = -1
        self.free_dev.append(pb)
        self.host[s, lb] = hb
        self.host_owner[hb] = self._pid(s, lb)
        self.counters.spills += 1
        self.counters.d2h_bytes += self.block_bytes
        return ("spill", s, lb, pb, hb)

    def _acquire_device(self, protect: frozenset,
                        ops: List[Op]) -> Optional[int]:
        """A free physical block, spilling unprotected victims if needed
        (spill ops are appended so the engine copies the victim out
        before its block is reused)."""
        while not self.free_dev:
            op = self._spill_one(protect)
            if op is None:
                return None
            ops.append(op)
        pb = self.free_dev.pop()
        self.peak_in_use = max(self.peak_in_use, self.in_use_device())
        return pb

    # --------------------------------------------------------- ensure
    def ensure_range(self, slot: int, lb_lo: int, lb_hi: int,
                     protect: Iterable[int] = ()
                     ) -> Tuple[List[Op], bool, int]:
        """Make logical blocks [lb_lo, lb_hi) of ``slot`` mapped and
        device-resident: resident blocks book a hit, host blocks a miss
        (+ fetch op), unmapped blocks a fresh alloc.  Returns (ops, ok,
        next_lb): the ordered data-movement ops, False when the arena
        cannot hold the demand even after spilling every unprotected
        block, and the first logical block NOT yet satisfied — the ops
        planned so far are still valid and must be executed; the caller
        preempts a request and *resumes* from next_lb, so each needed
        block is booked exactly once per preparation regardless of
        retries."""
        self.last_refusal_injected = False
        if self.faults is not None:
            ev = self.faults.fire("kv_pool")
            if ev is not None and ev.kind in ("exhaust", "fail"):
                self.last_refusal_injected = True
                return [], False, lb_lo
        protect = frozenset(protect) | {slot}
        self._tick += 1
        self.last_touch[slot] = self._tick
        ops: List[Op] = []
        lb_hi = min(lb_hi, self.blocks_per_slot)
        for lb in range(lb_lo, lb_hi):
            if self.dev[slot, lb] >= 0:
                self.counters.hits += 1
                continue
            if self.host[slot, lb] >= 0:
                pb = self._acquire_device(protect, ops)
                if pb is None:
                    return ops, False, lb
                hb = int(self.host[slot, lb])
                self.host[slot, lb] = -1
                self.host_owner[hb] = -1
                self.free_host.append(hb)
                self.dev[slot, lb] = pb
                self.dev_owner[pb] = self._pid(slot, lb)
                self.counters.misses += 1
                self.counters.h2d_bytes += self.block_bytes
                ops.append(("fetch", slot, lb, hb, pb))
                continue
            # fresh mapping: KV is append-only, so the prefix must hold
            assert lb == 0 or self.dev[slot, lb - 1] >= 0 \
                or self.host[slot, lb - 1] >= 0, \
                f"non-contiguous block map at slot {slot} lb {lb}"
            pb = self._acquire_device(protect, ops)
            if pb is None:
                return ops, False, lb
            self.dev[slot, lb] = pb
            self.dev_owner[pb] = self._pid(slot, lb)
            self.counters.allocs += 1
            ops.append(("alloc", slot, lb, pb))
        return ops, True, lb_hi

    def blocks_needed(self, n_tokens: int, block_tokens: int) -> int:
        return blocks_for_tokens(min(n_tokens,
                                     self.blocks_per_slot * block_tokens),
                                 block_tokens)

    def ensure_tokens(self, slot: int, n_tokens: int, block_tokens: int,
                      protect: Iterable[int] = ()
                      ) -> Tuple[List[Op], bool, int]:
        """Blocks covering ring positions [0, n_tokens) — what a decode
        chunk's attention reads plus the positions it will write."""
        return self.ensure_range(
            slot, 0, self.blocks_needed(n_tokens, block_tokens), protect)

    # -------------------------------------------------------- prefetch
    def prefetch(self, slot: int, lb: int) -> Optional[Op]:
        """Promote a host-resident block ahead of its group's turn, free
        arena blocks only (demotion to make room is the demand path's
        call, mirroring residency's miss-fills-free-slots rule)."""
        if self.host[slot, lb] < 0 or not self.free_dev:
            return None
        pb = self.free_dev.pop()
        self.peak_in_use = max(self.peak_in_use, self.in_use_device())
        hb = int(self.host[slot, lb])
        self.host[slot, lb] = -1
        self.host_owner[hb] = -1
        self.free_host.append(hb)
        self.dev[slot, lb] = pb
        self.dev_owner[pb] = self._pid(slot, lb)
        self.counters.prefetches += 1
        self.counters.h2d_bytes += self.block_bytes
        return ("fetch", slot, lb, hb, pb)

    # ------------------------------------------------------------ free
    def free_slot(self, slot: int) -> List[int]:
        """Release every block of a drained/preempted slot.  Returns the
        freed physical ids (their slot_pos planes are cleared lazily, at
        the next allocation)."""
        freed: List[int] = []
        for lb in range(self.blocks_per_slot):
            pb = int(self.dev[slot, lb])
            if pb >= 0:
                self.dev[slot, lb] = -1
                self.dev_owner[pb] = -1
                self.free_dev.append(pb)
                freed.append(pb)
                self.counters.frees += 1
            hb = int(self.host[slot, lb])
            if hb >= 0:
                self.host[slot, lb] = -1
                self.host_owner[hb] = -1
                self.free_host.append(hb)
                self.counters.frees += 1
        return freed

    # ------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        """Free-list conservation + ownership bijection + device/host
        exclusivity + prefix-contiguity (test hook)."""
        dev_owned = np.flatnonzero(self.dev_owner >= 0).tolist()
        assert sorted(self.free_dev + dev_owned) == \
            list(range(self.device_blocks))
        host_owned = np.flatnonzero(self.host_owner >= 0).tolist()
        assert sorted(self.free_host + host_owned) == \
            list(range(len(self.host_owner)))
        for pb in dev_owned:
            s, lb = self._pair(int(self.dev_owner[pb]))
            assert self.dev[s, lb] == pb
        for hb in host_owned:
            s, lb = self._pair(int(self.host_owner[hb]))
            assert self.host[s, lb] == hb
        both = (self.dev >= 0) & (self.host >= 0)
        assert not both.any(), "block device- AND host-resident"
        mapped = (self.dev >= 0) | (self.host >= 0)
        for s in range(self.n_slots):
            n = int(mapped[s].sum())
            assert mapped[s, :n].all(), f"non-prefix map at slot {s}"
        assert len(set(self.dev[self.dev >= 0].tolist())) == \
            int((self.dev >= 0).sum()), "double-mapped physical block"
