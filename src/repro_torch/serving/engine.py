"""Continuous-batching inference engine of the PyTorch port: the
``mode="continuous"`` subset of ``repro/serving/engine.py`` with resident
weights, and the KV cache either as a dense ring per slot or as the shared
block-paged arena with a host tier (``kv_paged``).

  * one persistent KV pool of ``num_ubs × ubatch`` slots is allocated at
    construction — ``num_ubs`` rotation groups of ``ubatch`` batch rows.  A
    slot is one row of one group's cache, recycled in place
    (``kvcache.insert_slot``) without touching its neighbours;
  * the Scheduler (a copy of the JAX package's) tracks each slot's
    lifecycle (free → prefilling → decoding → free) and admits single
    requests into freed slots via Algorithm 2's balance criterion;
  * admission prefills a request at batch 1 and a bucketed prompt width,
    then copies its KV row into the pool;
  * decode runs one fixed-shape masked chunk of ``decode_chunk`` tokens per
    rotation group (``steps.make_decode_chunk``): finished rows are masked,
    emit nothing and keep their cache position.

Block-paged KV (``kv_paged=True``, the paper's KV-offload ratio r_c): the
full-attention layers' rings become one shared arena of
``kv_gpu_ratio × (slots × max_seq / block_tokens)`` blocks of
``block_tokens`` positions (``kvcache.init_paged_arena``), and a pinned host
tier holds the blocks that do not fit (``core.offload``).  The host-side
``core.blockpool.BlockPool`` maps each (slot, logical block) and plans the
data movement; before each group's chunk the engine makes every decoding
row's blocks device-resident (spilling other groups' cold blocks to the
host tier, preempting the group's youngest request when even that is not
enough), uploads the group's page table once, and after it streams the next
group's spilled blocks back in ``paging.transfer_plan`` slices
(``kv_prefetch``).  Spills and fetches are copies between arena blocks and
the host tier on the current stream, in plan order.

Greedy transcripts, slot histories and every ``kv_traffic()`` counter equal
the JAX engine's on the same weights (the parity tests hold the two against
each other).  Paged weights, overlapped admission, module batching, static
mode, int8 KV and the fault plane are later slices, and so are sampling at a
temperature, EOS-aware reservations and long-prompt truncation:
``EngineConfig`` keeps the JAX package's names for the fields it has, and
has no others.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import blockpool, offload, paging
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import kvcache
from repro_torch.models.model import ExecPolicy
from repro_torch.serving import steps as serve_steps
from repro_torch.serving.sampling import sample
from repro_torch.serving.scheduler import Scheduler, SlotState


@dataclass
class EngineConfig:
    ubatch: int = 4                   # μ rows per slot group
    num_ubs: int = 2                  # rotation groups in the slot pool
    max_seq: int = 128                # ring width; longer requests abort
    eos_id: int = 1
    decode_chunk: int = 8             # tokens per masked decode chunk
    # ---------------------------------------- block-granular paged KV (r_c)
    kv_paged: bool = False            # shared block arena + page tables
    block_tokens: int = 16            # ring positions per KV block
    kv_gpu_ratio: float = 1.0         # r_c — sizes the device arena; the
                                      # remainder lives in the host tier
    kv_prefetch: bool = True          # stream the next rotation group's
                                      # spilled blocks back in
                                      # paging.transfer_plan slices


class _SlotGroup:
    """Device-side state of one rotation group: its slice of the KV pool
    (with ``kv_paged``, only the dense remainder: ``pos`` and any
    sliding-window rings), plus the last sampled token per row (the next
    decode input)."""

    def __init__(self, cache, ubatch: int):
        self.cache = cache
        self.last_tok = np.zeros((ubatch,), np.int32)


def _to_device(tree: Dict, device: torch.device) -> Dict:
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in tree.items()}


def _nbytes(tree: Dict) -> int:
    return sum(_nbytes(v) if isinstance(v, dict) else v.nbytes
               for v in tree.values())


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 policy: Optional[ExecPolicy] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.ecfg = ecfg
        self.policy = policy
        self.scheduler = Scheduler(
            ubatch=ecfg.ubatch, num_ubs=ecfg.num_ubs, max_seq=ecfg.max_seq,
            block_tokens=ecfg.block_tokens if ecfg.kv_paged else None)
        self._prefill = serve_steps.make_prefill_fill_step(cfg, policy)
        self._decode_chunk = serve_steps.make_decode_chunk(
            cfg, policy, eos_id=ecfg.eos_id, chunk=ecfg.decode_chunk)
        self._kv: Optional[blockpool.BlockPool] = None
        self._kv_arena: Dict[str, Dict] = {}
        self._kv_keys: Tuple[str, ...] = ()
        if ecfg.kv_paged:
            self._init_kv_pool()
        # the persistent slot pool: allocated once, recycled per slot; with
        # kv_paged the paged period positions live in the shared arena
        self.groups: List[_SlotGroup] = [
            _SlotGroup(kvcache.init_cache(cfg, ecfg.ubatch, ecfg.max_seq,
                                          skip_keys=self._kv_keys,
                                          device=self.device), ecfg.ubatch)
            for _ in range(ecfg.num_ubs)]
        # batch-1 admission-prefill cache, reset before every admission
        self._prefill_scratch = kvcache.init_cache(cfg, 1, ecfg.max_seq,
                                                   device=self.device)
        self.steps = 0
        self.tokens_out = 0

    def _init_kv_pool(self) -> None:
        """The block arena, its BlockPool, the pinned host tier and the
        gather accounting (``kv_paged``)."""
        cfg, ecfg = self.cfg, self.ecfg
        if ecfg.max_seq % ecfg.block_tokens:
            raise ValueError("max_seq must be a multiple of block_tokens "
                             "for the paged KV pool")
        self._kv_keys = kvcache.paged_period_keys(cfg)
        if not self._kv_keys:
            raise ValueError("kv_paged requires at least one "
                             "full-attention kv period position")
        mb = ecfg.max_seq // ecfg.block_tokens        # blocks per slot
        n_slots = ecfg.num_ubs * ecfg.ubatch
        total = n_slots * mb
        # r_c sizes the arena; the floor keeps one admission's worst case
        # (one slot) mappable so progress is always possible — kv_traffic()
        # reports the bytes actually allocated, never the un-clamped ratio
        device_blocks = min(total, max(
            mb, int(round(ecfg.kv_gpu_ratio * total))))
        self._kv_arena = kvcache.init_paged_arena(
            cfg, device_blocks, ecfg.block_tokens, device=self.device)
        block_bytes = sum(
            a.nbytes // a.shape[kvcache.arena_block_axis(name, stacked=True)]
            for g in self._kv_arena.values() for name, a in g.items())
        self._kv = blockpool.BlockPool(n_slots, mb, device_blocks,
                                       block_bytes)
        # host tier, big enough to hold every spillable block.  Block-major
        # (host block first), so that one block of a leaf is one contiguous
        # run of host memory for its copy to and from the arena
        self._kv_host = {
            key: {name: offload.host_store(
                (total,) + tuple(self._kv_block(a, name, 0).shape), a.dtype,
                self.device) for name, a in g.items()}
            for key, g in self._kv_arena.items()}
        self._kv_pending: List[Tuple[int, int]] = []
        self._kv_pending_set: set = set()
        # decode-path gather accounting: the paged kernel reads each row's
        # mapped blocks per step; a dense view would gather the full
        # max_seq ring for every row of the group
        self._kv_gather_steps = 0
        self._kv_gathered_blocks = 0
        self._kv_view_blocks = 0
        # constant byte terms for kv_traffic(): the dense-equivalent slot
        # pool (the baseline every paged-KV report compares against), and
        # what the paged pool holds on the device — the arena, the dense
        # remainder of the groups and the page tables
        self._kv_dense_bytes = ecfg.num_ubs * _nbytes(kvcache.init_cache(
            cfg, ecfg.ubatch, ecfg.max_seq, device="meta"))
        rem = kvcache.init_cache(cfg, ecfg.ubatch, ecfg.max_seq,
                                 skip_keys=self._kv_keys, device="meta")
        self._kv_device_bytes = (_nbytes(self._kv_arena)
                                 + ecfg.num_ubs * _nbytes(rem)
                                 + int(self._kv.dev.nbytes))

    # ----------------------------------------------------------- public
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        return self.scheduler.submit(np.asarray(prompt, np.int32),
                                     max_new_tokens)

    @torch.no_grad()
    def step(self) -> bool:
        """One engine tick: admit new work into free slots, then decode a
        `decode_chunk`-token masked chunk per rotation group and recycle
        the slots that drain.  Returns True if any work was done."""
        self._admit_continuous()
        if not self.scheduler.has_live_slots():
            return False
        for gid in range(self.ecfg.num_ubs):
            self._tick_group(gid)
        self.steps += 1
        return True

    def run_until_idle(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        while self.step() and self.steps < max_steps:
            pass
        return {rid: r.generated for rid, r in self.scheduler.requests.items()}

    # ----------------------------------------------------- shared pieces
    def _bucket(self, input_len: int) -> int:
        # bucket the padded prompt length: one prefill shape per bucket
        return min(-(-input_len // 16) * 16, self.ecfg.max_seq)

    @staticmethod
    def _emit(toks, emitted, row_req):
        """Replay a chunk's emissions into request transcripts.
        row_req[i] is the request owning row i (or None)."""
        count = 0
        for t in range(toks.shape[0]):
            for i, r in enumerate(row_req):
                if r is not None and emitted[t, i]:
                    r.generated.append(int(toks[t, i]))
                    count += 1
        return count

    # ------------------------------------------------- continuous mode
    def _admit_continuous(self):
        """Fill freed slots: per admitted request, prefill at its own
        bucket width (batch 1) and copy the KV into the pool row.
        Re-admitted (preempted) requests prefill prompt + transcript."""
        for slot in self.scheduler.admit_to_slots():
            r = slot.req
            eff = r.effective_prompt
            S = self._bucket(len(eff))
            toks = np.zeros((1, S), np.int32)
            toks[0, :len(eff)] = eff
            scratch = kvcache.reset_slot(self._prefill_scratch, 0)
            logits, single = self._prefill(
                self.params, torch.as_tensor(toks, device=self.device),
                scratch, torch.tensor([len(eff)], dtype=torch.int32,
                                      device=self.device))
            first = int(sample(logits)[0])
            r.generated.append(first)
            group = self.groups[slot.gid]
            if self._kv is not None:
                # book the prompt's blocks (alloc/fetch/spill-to-make-room)
                # before the slot-insert scatters through the page table
                idx = self._slot_of(slot)
                ops, ok, _ = self._kv.ensure_tokens(
                    idx, len(eff), self.ecfg.block_tokens, (idx,))
                self._kv_exec(ops)
                if not ok:
                    raise RuntimeError("admission exceeds the KV arena floor")
                kvcache.insert_slot(self._compose_kv(group.cache, slot.gid),
                                    single, slot.row)
            else:
                kvcache.insert_slot(group.cache, single, slot.row)
            group.last_tok[slot.row] = first
            if len(r.generated) >= r.max_new_tokens:
                self._retire_slot(slot)          # quota met at prefill
            else:
                self.scheduler.start_decode(slot)

    def _retire_slot(self, slot) -> None:
        # no cache reset: the row stays masked while free, and the next
        # admission's insert_slot overwrites every leaf of the row.  Paged
        # KV: the slot's arena and host blocks return to the free lists;
        # fresh allocations clear their slot_pos plane at map time
        if self._kv is not None:
            self._kv.free_slot(self._slot_of(slot))
        self.scheduler.finish(slot)

    def _tick_group(self, gid: int) -> None:
        """One rotation group's masked decode chunk."""
        group = self.groups[gid]
        if self._kv is not None:
            # fetch/alloc this group's working set (may preempt)
            self._kv_prepare_group(gid, self.ecfg.decode_chunk)
        slots = self.scheduler.slots[gid]
        active = np.array([s.state == SlotState.DECODE for s in slots])
        if not active.any():
            return
        rem = np.array(
            [s.req.remaining if s.state == SlotState.DECODE else 0
             for s in slots], np.int32)
        dev = self.device
        cache = group.cache
        if self._kv is not None:
            self._kv_note_gather(gid, self.ecfg.decode_chunk)
            cache = self._compose_kv(cache, gid)
        cache, tok, act2, _, toks, emitted = self._decode_chunk(
            self.params, cache,
            torch.as_tensor(group.last_tok[:, None], device=dev),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(rem, device=dev))
        group.cache = cache
        group.last_tok = tok[:, 0].cpu().numpy()          # sync
        act2 = act2.cpu().numpy()
        self.tokens_out += self._emit(
            toks.cpu().numpy(), emitted.cpu().numpy(),
            [s.req if s.state == SlotState.DECODE else None for s in slots])
        for i, s in enumerate(slots):
            if s.state == SlotState.DECODE and not act2[i]:
                self._retire_slot(s)
        if self._kv is not None and self.ecfg.kv_prefetch:
            # the KV analogue of the router-ahead weight prefetch: stream
            # the next group's spilled blocks back in transfer_plan slices
            self._kv_enqueue_prefetch(gid)
            self._kv_drain_prefetch(gid)

    # ------------------------------ block-granular paged KV (data+control)
    def _slot_of(self, slot) -> int:
        return slot.gid * self.ecfg.ubatch + slot.row

    def _compose_kv(self, dense_cache: Dict, gid: int) -> Dict:
        """The dispatch cache of slot group `gid`: its dense part plus the
        shared arena and the group's page table, built on the host from
        the BlockPool and copied to the device once, shared by every layer
        (a broadcast view over the layer axis)."""
        b = self.ecfg.ubatch
        pt = torch.from_numpy(self._kv.device_table(
            [gid * b + r for r in range(b)])).to(self.device)
        ptl = pt.expand((self.cfg.num_periods,) + tuple(pt.shape))
        cache = dict(dense_cache)
        for key, g in self._kv_arena.items():
            cache[key] = {**g, "page_table": ptl}
        return cache

    @staticmethod
    def _kv_block(a: torch.Tensor, name: str, i: int) -> torch.Tensor:
        """Block `i` of a stacked arena leaf (a view)."""
        return a.select(kvcache.arena_block_axis(name, stacked=True), i)

    def _kv_exec(self, ops) -> None:
        """Execute a BlockPool plan in order on the current stream:
        ``spill`` copies an arena block out to the host tier (D2H),
        ``fetch`` copies a host block back in (H2D), ``alloc`` marks a
        fresh block, whose slot_pos plane is cleared at the end — stale
        positions from the previous owner must never satisfy a validity
        mask.  Stream order keeps a block's copy-out ahead of its reuse."""
        fresh = []
        for op in ops:
            if op[0] == "spill":
                _, _s, _lb, pb, hb = op
                for key, g in self._kv_arena.items():
                    for name, a in g.items():
                        self._kv_host[key][name][hb].copy_(
                            self._kv_block(a, name, pb), non_blocking=True)
            elif op[0] == "fetch":
                _, _s, _lb, hb, pb = op
                for key, g in self._kv_arena.items():
                    for name, a in g.items():
                        self._kv_block(a, name, pb).copy_(
                            self._kv_host[key][name][hb], non_blocking=True)
            else:                                       # ("alloc", s, lb, pb)
                fresh.append(op[3])
        if fresh:
            idx = torch.tensor(fresh, device=self.device)
            for g in self._kv_arena.values():
                g["slot_pos"][:, idx] = -1

    def _kv_prepare_group(self, gid: int, chunk: int) -> None:
        """Pre-dispatch guard for the paged pool: every decoding row's
        mapped blocks must be device-resident (attention reads its whole
        history) and the blocks its next `chunk` tokens will write must be
        mapped.  Cold blocks of other slots spill to the host tier to make
        room; on arena exhaustion the youngest decoding request in the
        group is preempted (recompute preemption — blocks freed, request
        re-queued with its transcript intact).  Retries resume each slot
        at its first unsatisfied block, so every needed block books exactly
        one hit or miss per preparation."""
        slots = self.scheduler.slots[gid]
        booked: Dict[int, int] = {}          # slot idx -> blocks satisfied
        while True:
            decoding = [s for s in slots if s.state == SlotState.DECODE]
            protect = [self._slot_of(s) for s in decoding]
            ok = True
            for s in decoding:
                idx = self._slot_of(s)
                need = self._kv.blocks_needed(
                    s.req.footprint + min(chunk, s.req.remaining),
                    self.ecfg.block_tokens)
                if booked.get(idx, 0) >= need:
                    continue
                ops, ok, nxt = self._kv.ensure_range(
                    idx, booked.get(idx, 0), need, protect)
                self._kv_exec(ops)
                booked[idx] = nxt
                if not ok:
                    break
            if ok:
                return
            if len(decoding) <= 1:
                raise RuntimeError("a single request exceeds the KV arena "
                                   "(device_blocks floor)")
            victim = max(decoding, key=lambda s: s.req.rid)   # youngest
            self.scheduler.preempt(victim)
            self._kv.free_slot(self._slot_of(victim))
            booked.pop(self._slot_of(victim), None)

    def _kv_enqueue_prefetch(self, gid: int) -> None:
        """Queue the next rotation group's spilled blocks (the KV analogue
        of Algorithm 1's weight lookahead)."""
        for s in self.scheduler.slots[(gid + 1) % self.ecfg.num_ubs]:
            if s.state != SlotState.DECODE:
                continue
            idx = self._slot_of(s)
            for lb in self._kv.host_resident_blocks(idx):
                t = (idx, lb)
                if t not in self._kv_pending_set:
                    self._kv_pending.append(t)
                    self._kv_pending_set.add(t)

    def _kv_drain_prefetch(self, gid: int) -> None:
        """Promote this rotation position's ``paging.transfer_plan`` slice
        of the pending block queue into free arena blocks (no demotions on
        the prefetch path); entries that became stale or found no free
        block fall back to the demand path."""
        if not self._kv_pending:
            return
        take = set(paging.transfer_plan(len(self._kv_pending),
                                        self.ecfg.num_ubs)
                   [gid % self.ecfg.num_ubs])
        chosen = [t for i, t in enumerate(self._kv_pending) if i in take]
        self._kv_pending = [t for i, t in enumerate(self._kv_pending)
                            if i not in take]
        self._kv_pending_set.difference_update(chosen)
        for idx, lb in chosen:
            op = self._kv.prefetch(idx, lb)
            if op is not None:
                self._kv_exec([op])

    def _kv_note_gather(self, gid: int, steps: int) -> None:
        """Book the decode-path KV gather of one dispatched chunk: the
        paged kernel reads each row's mapped blocks once per decode step
        (per layer), so gathered bytes scale with the page table's mapped
        blocks, not with ``max_seq``."""
        b = self.ecfg.ubatch
        rows = [gid * b + r for r in range(b)]
        mapped = sum(self._kv.n_mapped(r) for r in rows)
        self._kv_gather_steps += steps
        self._kv_gathered_blocks += mapped * steps
        self._kv_view_blocks += len(rows) * self._kv.blocks_per_slot * steps

    def kv_traffic(self) -> Dict[str, float]:
        """Device-KV accounting of the paged pool (``kv_paged``): bytes it
        occupies on the device against the dense max_seq-wide equivalent,
        plus the host-tier stream counters (bytes the planned spills and
        fetches copied)."""
        c = self._kv.counters
        out: Dict[str, float] = dict(
            tokens_out=self.tokens_out,
            dense_equiv_bytes=self._kv_dense_bytes,
            mode="kv_paged",
            block_tokens=self.ecfg.block_tokens,
            device_blocks=self._kv.device_blocks,
            peak_blocks_in_use=self._kv.peak_in_use,
            arena_utilization=(self._kv.peak_in_use
                               / max(1, self._kv.device_blocks)),
            device_kv_bytes=self._kv_device_bytes,
            arena_bytes=_nbytes(self._kv_arena),
            hits=c.hits, misses=c.misses, prefetches=c.prefetches,
            spills=c.spills, allocs=c.allocs, frees=c.frees,
            h2d_bytes=c.h2d_bytes, d2h_bytes=c.d2h_bytes,
            hit_rate=c.hit_rate,
        )
        bb = self._kv.block_bytes
        steps = max(1, self._kv_gather_steps)
        out.update(
            gathered_bytes=self._kv_gathered_blocks * bb,
            gathered_bytes_per_step=self._kv_gathered_blocks * bb / steps,
            paged_view_bytes_per_step=self._kv_view_blocks * bb / steps,
            gather_reduction_vs_view=(self._kv_view_blocks
                                      / max(1, self._kv_gathered_blocks)),
        )
        return out
