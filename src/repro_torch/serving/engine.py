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
    then copies its KV row into the pool — or, with ``overlap=True``,
    stages it: the prompt drains through chunks of at most
    ``prefill_chunk`` tokens on a double-buffered batch-1 scratch, one
    chunk per tick ahead of the decode chunks, each landing in the pool row
    at once (``kvcache.insert_slot_span``), so that a long admission does
    not stall the decoding groups (Algorithm 1's CGOPipe at request level);
  * decode runs one fixed-shape masked chunk of ``decode_chunk`` tokens per
    rotation group (``steps.make_decode_chunk``): finished rows are masked,
    emit nothing and keep their cache position;
  * reservations are worst-case remaining quota by default, or EOS-aware
    (``reserve_mode="ewma"``): expected generation lengths from a running
    EWMA, charged against a per-group budget ``cache_tokens`` (by default
    the group's slice of the pool), with recompute preemption when the
    optimism was wrong (the scheduler's ``enforce_budget`` runs before
    every dispatch, and with the paged pool the preempted slots' blocks
    are swept back to the free lists).

Module-based batching (``module_batch=True``, the MoE-Gen direction):
windows of ``module_groups`` rotation groups decode through one dispatch.
The groups' slot caches are views of one pool cache, group-major, so a
window's cache is a view of its groups' rows (``kvcache.slot_rows``),
written in place; attention, the norms, the router's scores and
``lm_head`` run group by group (every row computes as in its lockstep
dispatch, bit for bit on the card too: a product's or a row sum's bits
can change with the row count), while each MoE layer stages all the
window's routed tokens into per-(group, expert) capacity spans of one
buffer: one ``moe_ffn`` launch, and on the expert-paged path one gather
that reads each activated span once for the whole window, booked per
window (``ExpertResidency.observe_window``).  A remainder window
(``num_ubs`` not a multiple of the width) runs lockstep;
``module_stage_tokens`` narrows the window toward lockstep where the
staging rows would exceed it.

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

Expert-granular paged weights (``expert_paged=True``, the paper's weight
offloading with the ratio r_w): the blocks' weights live in page-locked host
stores (``core.paging.pack_block_groups_split``).  Each layer's shared span
(attention, norms, router) streams through a two-slot device buffer in
every forward pass; the MoE FFN gathers only the activated experts' spans
per layer (``kernels.ops.expert_gather``), resident spans from a fixed
device pool of ``w_gpu_ratio × L × E`` spans and misses from the host
store on the copy engine.  On the card each gather waits for the device to
reach it (its kernel writes which spans missed; ``kernels.expert_gather``),
so a dispatch returns once the device has reached the chunk's last gather.
The host-side ``core.residency.ExpertResidency`` decides which spans hold
pool slots (popularity EWMA, demand admits, router-ahead and gate-predicted
prefetch, replication) and counts hits, misses and bytes.  Within a tick,
in the reference's order: the map is snapshotted and the resident spans pinned;
the chunk is dispatched with the map uploaded once into a static device
buffer; then the next group's router-ahead set and the gate predictor's
spans are queued and this position's ``paging.transfer_plan`` slice of the
queue is copied into free pool slots on a copy stream; the results are
read; the spans are unpinned; the refused part of the slice is retried;
the chunk's activation counts are booked (demand admits copy their spans
in).  Every dispatch waits for the copy stream first.  The embedding, the
final norm and ``lm_head`` stay resident.  ``expert_paged`` composes with
``kv_paged`` (the paper's setting with both offload ratios): a dispatch
prepares the KV working set first, reads the arena through its page table
and the experts through the residency map, and the KV prefetch drains
after the expert one, in the reference's order.

Greedy transcripts, slot histories and every ``kv_traffic()`` and
``weight_traffic()`` counter equal the JAX engine's on the same weights
(the parity tests hold the two against each other).  Whole-layer paged
weights, static mode, int8 KV and the fault plane (with the degradation
ladder's window rung) are later slices, and so are sampling at a
temperature and long-prompt truncation: ``EngineConfig`` keeps the JAX
package's names for the fields it has, and has no others.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import blockpool, offload, paging, residency
from repro_torch.core.batching import blocks_for_tokens
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
    overlap: bool = False             # staged chunked-prefill admission
    prefill_chunk: int = 32           # chunk width for overlapped prefill
    reserve_mode: str = "worst"       # "worst" | "ewma" (EOS-aware)
    cache_tokens: Optional[int] = None  # per-group KV policy budget;
    # default = the physical pool slice (max_seq × ubatch).  A tighter
    # budget (e.g. from the HRM policy) is what makes EOS-aware
    # reservations bite: more concurrent admissions, preemption on miss
    # ---------------------------------------- block-granular paged KV (r_c)
    kv_paged: bool = False            # shared block arena + page tables
    block_tokens: int = 16            # ring positions per KV block
    kv_gpu_ratio: float = 1.0         # r_c — sizes the device arena; the
                                      # remainder lives in the host tier
    kv_prefetch: bool = True          # stream the next rotation group's
                                      # spilled blocks back in
                                      # paging.transfer_plan slices
    # ------------------------------------ expert-granular paged weights
    page_elems: int = 1 << 16
    expert_paged: bool = False        # per-(layer, expert) spans + residency
    w_gpu_ratio: float = 0.25         # r_w — sizes the resident expert pool
    expert_slots: Optional[int] = None  # explicit pool size (spans) override
    prefetch: bool = True             # router-ahead prefetch for group j+1
    residency_alpha: float = 0.25     # expert-popularity EWMA step
    residency_victim_quota: int = 1   # demand misses may evict this many
                                      # victims per chunk (cold-start aid)
    # intra-pass predictive prefetch: the cross-layer gate predictor
    # (core.residency.GatePredictor) queues the spans the dispatching
    # group's next chunk will activate at layers i+1..i+lookahead, beside
    # the router-ahead entries (first come, deduped); under `prefetch`
    predict: bool = True
    predict_lookahead: int = 2        # layer shifts predicted per dispatch
    predict_topk: Optional[int] = None  # experts kept per predicted layer
    # book a chunk's passes against a resident mask that evolves across
    # them (a demand-missed span streams once per chunk, in-flight
    # admissions count from the second pass); False: the frozen snapshot
    intra_pass: bool = True
    # hot-expert replication: this fraction of the pool may be pinned to
    # the popularity-EWMA top spans (exit at replica_exit × the enter bar)
    replicate_frac: float = 0.0
    replica_exit: float = 0.5
    # ------------------------------------ module-based batching (MoE-Gen)
    # decode `module_groups` rotation groups through one dispatch per
    # window: attention and router run per row as before, and the MoE
    # layers stage every group's routed tokens against one expert-span
    # read per layer step
    module_batch: bool = False
    module_groups: Optional[int] = None   # groups per window (default: all
                                      # num_ubs; capped at num_ubs)
    module_stage_tokens: Optional[int] = None  # staging-buffer row budget:
    # when G·ubatch would exceed it the window shrinks toward lockstep


class _SlotGroup:
    """Device-side state of one rotation group: its slice of the KV pool
    (with ``kv_paged``, only the dense remainder: ``pos`` and any
    sliding-window rings), plus the last sampled token per row (the next
    decode input)."""

    def __init__(self, cache, ubatch: int):
        self.cache = cache
        self.last_tok = np.zeros((ubatch,), np.int32)
        # expert-paged: the expert set this group's router gated on the
        # last step of its previous chunk ({key: (L, E) bool}) — the
        # router-ahead prefetch prediction for its next chunk
        self.pred: Dict[str, np.ndarray] = {}


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
                 device: DeviceLike = None,
                 paged_weights: Optional[paging.PagedWeights] = None):
        """With ``expert_paged``, the blocks' weights come from
        ``params["blocks"]`` (packed here into host stores) or, already
        packed, from ``paged_weights``; ``params`` then needs no "blocks",
        and its other leaves go to the device."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.policy = policy
        resident = ({k: v for k, v in params.items() if k != "blocks"}
                    if ecfg.expert_paged else params)
        self.params = _to_device(resident, self.device)
        self.scheduler = Scheduler(
            ubatch=ecfg.ubatch, num_ubs=ecfg.num_ubs, max_seq=ecfg.max_seq,
            cache_tokens=ecfg.cache_tokens, reserve_mode=ecfg.reserve_mode,
            block_tokens=ecfg.block_tokens if ecfg.kv_paged else None)
        self.paged_blocks: Optional[paging.PagedWeights] = None
        self.residency: Dict[str, residency.ExpertResidency] = {}
        self._expert_pool: Dict[str, torch.Tensor] = {}
        self._expert_map: Dict[str, torch.Tensor] = {}
        # prefetch queue entries are (key, layer, expert, cause, priority)
        # with cause "router" or "predicted"; the dedupe set keys on (key,
        # layer, expert), so a span queued by both paths is fetched once
        self._pending: List[Tuple[str, int, int, str, Optional[float]]] = []
        self._pending_set: set = set()
        self._predictors: Dict[str, residency.GatePredictor] = {}
        self._copy_stream = None
        self._fwd_passes = 0          # forward passes dispatched (traffic)
        if ecfg.expert_paged:
            self._init_expert_pool(params.get("blocks"), paged_weights)
        self._prefill = serve_steps.make_prefill_fill_step(
            cfg, policy, paged_blocks=self.paged_blocks)
        self._decode_chunk = serve_steps.make_decode_chunk(
            cfg, policy, paged_blocks=self.paged_blocks, eos_id=ecfg.eos_id,
            chunk=ecfg.decode_chunk)
        # module-based batching: windows of _mg rotation groups decode
        # through one dispatch; a remainder window runs lockstep
        self._mg = 1
        if ecfg.module_batch:
            mg = max(1, min(ecfg.module_groups or ecfg.num_ubs,
                            ecfg.num_ubs))
            if ecfg.module_stage_tokens is not None:
                # the staging buffer bounds how many groups' routed tokens
                # accumulate per window; overflow shrinks the window
                # toward lockstep instead of dropping tokens
                mg = max(1, min(mg, ecfg.module_stage_tokens // ecfg.ubatch))
            self._mg = mg
        self._decode_window = (serve_steps.make_decode_chunk(
            cfg, policy, paged_blocks=self.paged_blocks, eos_id=ecfg.eos_id,
            chunk=ecfg.decode_chunk, token_groups=self._mg)
            if self._mg > 1 else None)
        self._windows = [list(range(i, min(i + self._mg, ecfg.num_ubs)))
                         for i in range(0, ecfg.num_ubs, self._mg)]
        # the dense-equivalent slot pool: the baseline every kv_traffic()
        # report compares against
        self._kv_dense_bytes = ecfg.num_ubs * _nbytes(kvcache.init_cache(
            cfg, ecfg.ubatch, ecfg.max_seq, device="meta"))
        self._kv: Optional[blockpool.BlockPool] = None
        self._kv_arena: Dict[str, Dict] = {}
        self._kv_keys: Tuple[str, ...] = ()
        if ecfg.kv_paged:
            self._init_kv_pool()
        # the persistent slot pool: allocated once, recycled per slot; with
        # kv_paged the paged period positions live in the shared arena.
        # One cache of every group's rows, group-major: each group holds
        # views of its rows, and a window of consecutive groups is a view
        self._slot_pool = kvcache.init_cache(
            cfg, ecfg.num_ubs * ecfg.ubatch, ecfg.max_seq,
            skip_keys=self._kv_keys, device=self.device)
        self.groups: List[_SlotGroup] = [
            _SlotGroup(c, ecfg.ubatch)
            for c in kvcache.split_slot_cache(self._slot_pool, ecfg.num_ubs)]
        # overlapped (staged) admission: PREFILL slots in FIFO order, the
        # scratch of the one in flight, and two batch-1 scratches (the next
        # admission's first chunk takes one while the other is reset)
        self._staged: List = []
        self._stage_scratch = None
        self._free_scratches: List[Dict] = []
        self._prefill_scratch = None
        if ecfg.overlap:
            self._prefill_chunk = serve_steps.make_prefill_chunk(
                cfg, policy, paged_blocks=self.paged_blocks)
            self._free_scratches = [
                kvcache.init_cache(cfg, 1, ecfg.max_seq, device=self.device)
                for _ in range(2)]
        else:
            # batch-1 admission-prefill cache, reset before every admission
            self._prefill_scratch = kvcache.init_cache(
                cfg, 1, ecfg.max_seq, device=self.device)
        self.steps = 0
        self.tokens_out = 0

    def _init_expert_pool(self, blocks, pw) -> None:
        """The host stores of the packed weights, the device pool and the
        residency control plane of every MoE group (``expert_paged``)."""
        ecfg = self.ecfg
        if pw is None:
            pw = paging.pack_block_groups_split(blocks, ecfg.page_elems,
                                                self.device)
        if not pw.expert_manifests:
            raise ValueError("expert_paged requires a MoE config "
                             "(no routed-expert leaves found)")
        self.paged_blocks = pw
        for key, em in pw.expert_manifests.items():
            slots = (ecfg.expert_slots if ecfg.expert_slots is not None
                     else residency.slots_from_ratio(
                         ecfg.w_gpu_ratio, em.num_layers, em.num_experts))
            self.residency[key] = residency.ExpertResidency(
                em.num_layers, em.num_experts, capacity=slots,
                span_bytes=em.span_bytes, alpha=ecfg.residency_alpha,
                victim_quota=ecfg.residency_victim_quota,
                replicate_frac=ecfg.replicate_frac,
                replica_exit=ecfg.replica_exit,
                protect_ttl=max(2, ecfg.num_ubs))
            if ecfg.predict and ecfg.prefetch:
                self._predictors[key] = residency.GatePredictor(
                    em.num_layers, em.num_experts)
            self._expert_pool[key] = torch.zeros(
                (max(1, slots), em.pages_per_expert, em.page_elems),
                dtype=pw.expert_pages[key].dtype, device=self.device)
            self._expert_map[key] = torch.full(
                (em.num_layers, em.num_experts), -1, dtype=torch.int32,
                device=self.device)
        self._copy_stream = offload.copy_stream(self.device)

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
        # constant byte term for kv_traffic(): what the paged pool holds
        # on the device — the arena, the dense remainder of the groups and
        # the page tables
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
        `decode_chunk`-token masked chunk per rotation group (or per
        module-batched window of groups) and recycle the slots that drain.
        With ``overlap`` admission is staged: one prompt chunk is
        prefilled per tick, ahead of the decode chunks.  Returns True if
        any work was done."""
        if self.ecfg.overlap:
            self._staged.extend(self.scheduler.admit_to_slots())
            did = self._prefill_tick()
            # cold pool: nothing decodes yet, so drain prefill chunks back
            # to back instead of one per idle tick
            while did and self._staged and not any(
                    s.state == SlotState.DECODE
                    for grp in self.scheduler.slots for s in grp):
                did = self._prefill_tick()
        else:
            self._admit_continuous()
            did = False
        if not (did or self.scheduler.has_live_slots()):
            return False
        for w in self._windows:                   # CGOPipe rotation
            if len(w) == self._mg:
                self._tick_window(w)
            else:
                # the remainder groups of a rotation that does not divide
                # into windows run lockstep, one dispatch each
                for gid in w:
                    self._tick_window([gid])
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

    def _chunk_bucket(self, rem: int) -> int:
        # next power of two capped at the full chunk width: mid-prompt
        # chunks take the full width, the final partial chunk a smaller one
        w = 1
        while w < rem:
            w <<= 1
        return min(w, self.ecfg.prefill_chunk)

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
            logits, single = self._run_prefill(
                self._prefill, torch.as_tensor(toks, device=self.device),
                scratch,
                torch.tensor([len(eff)], dtype=torch.int32,
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
                kvcache.insert_slot(
                    self._compose_kv(group.cache, [slot.gid]), single,
                    slot.row)
            else:
                kvcache.insert_slot(group.cache, single, slot.row)
            group.last_tok[slot.row] = first
            if len(r.generated) >= r.max_new_tokens:
                self._retire_slot(slot)          # quota met at prefill
            else:
                self.scheduler.start_decode(slot)

    def _run_prefill(self, step_fn, *args):
        """Admission prefill (monolithic or one staged chunk), absorbing
        the expert-paged protocol: one forward pass booked, the residency
        snapshot taken at dispatch, the activation counts accounted.
        Returns (logits, cache)."""
        self._fwd_passes += 1
        if not self.residency:
            return step_fn(self.params, *args)
        snap = self._resident_snap()
        logits, cache, counts = step_fn(self.params, *args,
                                        self._expert_state())
        self._account_counts(counts, snap=snap)
        return logits, cache

    def _prefill_tick(self) -> bool:
        """Run one chunk of the staged admission at the head of the
        prefill queue (request-level CGOPipe: admission work interleaves
        with the groups' decode chunks instead of stalling them).  The
        chunk runs on a batch-1 scratch and lands in the pool row at once
        (``kvcache.insert_slot_span``)."""
        if not self._staged:
            return False
        slot = self._staged[0]
        r = slot.req
        group = self.groups[slot.gid]
        if self._stage_scratch is None:          # the head starts fresh
            self._stage_scratch = self._free_scratches.pop()
            # clear the previous occupant's remnants once: span inserts
            # overwrite only their own ring range
            kvcache.reset_slot(group.cache, slot.row)
        eff = r.effective_prompt
        t = slot.prefill_pos
        rem = len(eff) - t
        width = self._chunk_bucket(rem)
        n = min(rem, width)
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = eff[t:t + n]
        logits, self._stage_scratch = self._run_prefill(
            self._prefill_chunk, torch.as_tensor(toks, device=self.device),
            self._stage_scratch,
            torch.tensor([n], dtype=torch.int32, device=self.device))
        if self._kv is not None:
            # only the span's blocks need to be mapped and resident for
            # the insert; earlier prompt blocks may stay spilled until the
            # slot decodes (the chunk attends to the scratch, not the pool)
            idx = self._slot_of(slot)
            bt = self.ecfg.block_tokens
            ops, ok, _ = self._kv.ensure_range(
                idx, t // bt, blocks_for_tokens(t + width, bt), (idx,))
            self._kv_exec(ops)
            if not ok:
                raise RuntimeError("a staged prefill chunk exceeds the KV "
                                   "arena floor")
            kvcache.insert_slot_span(
                self._compose_kv(group.cache, [slot.gid]),
                self._stage_scratch, slot.row, t, length=width)
        else:
            kvcache.insert_slot_span(group.cache, self._stage_scratch,
                                     slot.row, t, length=width)
        self.scheduler.prefill_progress(slot, n)
        if slot.prefill_pos >= len(eff):         # final chunk: first token
            first = int(sample(logits)[0])
            r.generated.append(first)
            group.last_tok[slot.row] = first
            self._free_scratches.append(
                kvcache.reset_slot(self._stage_scratch, 0))
            self._stage_scratch = None
            self._staged.pop(0)
            if len(r.generated) >= r.max_new_tokens:
                self._retire_slot(slot)
            else:
                self.scheduler.start_decode(slot)
        return True

    def _retire_slot(self, slot) -> None:
        # no cache reset: the row stays masked while free, and the next
        # admission's insert_slot overwrites every leaf of the row.  Paged
        # KV: the slot's arena and host blocks return to the free lists;
        # fresh allocations clear their slot_pos plane at map time
        if self._kv is not None:
            self._kv.free_slot(self._slot_of(slot))
        self.scheduler.finish(slot)

    def _tick_window(self, gids: List[int]) -> None:
        """One decode dispatch over the rotation groups `gids`: one group
        alone (lockstep: attention and expert FFN at the same ubatch), or
        a module-batched window, whose groups' rows of the slot pool are
        one view (with one arena composition and a window-wide page
        table), so that the expert phase inside streams each activated
        span once for the whole window; the tokens are split back per
        group.  Rows are independent through attention and the MoE
        staging reproduces per-group bucketing, so each request's greedy
        transcript equals the lockstep schedule's."""
        b, chunk = self.ecfg.ubatch, self.ecfg.decode_chunk
        window = len(gids) > 1
        # EOS-aware reservations are optimistic: preempt (recompute) the
        # youngest rows of a group this chunk could take past its budget
        for gid in gids:
            self.scheduler.enforce_budget(gid, chunk)
        if self._kv is not None:
            self._kv_sweep()              # blocks of budget-preempted slots
            # fetch/alloc the working set of every row the dispatch reads
            # (one protect set for the window; may preempt)
            self._kv_prepare_group(gids, chunk)
        slot_rows = [self.scheduler.slots[g] for g in gids]
        slots = [s for grp in slot_rows for s in grp]
        active = np.array([s.state == SlotState.DECODE for s in slots])
        if not active.any():
            return
        rem = np.array(
            [s.req.remaining if s.state == SlotState.DECODE else 0
             for s in slots], np.int32)
        dev = self.device
        holders = [self.groups[g] for g in gids]
        # the window's rows of the pool (views): the chunk writes their
        # rings in place and returns a new "pos", copied back below
        cache = kvcache.slot_rows(self._slot_pool, gids[0] * b,
                                  len(gids) * b)
        pos = cache["pos"]
        last = np.concatenate([h.last_tok for h in holders])
        if self._kv is not None:
            self._kv_note_gather(gids, chunk)
            cache = self._compose_kv(cache, gids)
        args = (self.params, cache,
                torch.as_tensor(last[:, None], device=dev),
                torch.as_tensor(active, device=dev),
                torch.as_tensor(rem, device=dev))
        fn = self._decode_window if window else self._decode_chunk
        self._fwd_passes += chunk
        if self.residency:
            cache, tok, act2, toks, emitted = self._decode_expert(
                fn, args, holders, gids)
        else:
            cache, tok, act2, _, toks, emitted = fn(*args)
        pos.copy_(cache["pos"])
        tok = tok[:, 0].cpu().numpy()                     # sync
        act2, toks, emitted = (act2.cpu().numpy(), toks.cpu().numpy(),
                               emitted.cpu().numpy())
        for j, (h, grp) in enumerate(zip(holders, slot_rows)):
            rows = slice(j * b, (j + 1) * b)
            h.last_tok = tok[rows]
            self.tokens_out += self._emit(
                toks[:, rows], emitted[:, rows],
                [s.req if s.state == SlotState.DECODE else None
                 for s in grp])
            for i, s in enumerate(grp):
                if s.state == SlotState.DECODE and not act2[j * b + i]:
                    self._retire_slot(s)
        if self._kv is not None and self.ecfg.kv_prefetch:
            # the KV analogue of the router-ahead weight prefetch: stream
            # the next window's spilled blocks back in transfer_plan slices
            self._kv_enqueue_prefetch(gids)
            self._kv_drain_prefetch(gids)

    # ---------------------------------- expert residency (data+control)
    def _decode_expert(self, fn, args, holders, gids: List[int]):
        """One dispatch (a group's chunk, or a window's) on the
        expert-paged path.  Every resident span is pinned for the dispatch
        (the chunk may read any of them from the pool); after the
        dispatch, the router-ahead sets of the next window's groups and
        the gate predictor's spans for these groups' next chunk are queued
        and the union of these positions' slices drains into free slots on
        the copy stream; once the results are back, the spans are
        unpinned, the refused part of the slice retried and the counts
        booked (per window: a span streams once however many groups
        routed to it).  On the card the dispatch returns only once the
        device has reached the chunk's last gather (each gather waits for
        its plan), so these copies overlap the chunk's tail alone."""
        snap = self._resident_snap()
        for r in self.residency.values():
            r.pin_resident()
        cache, tok, act2, _, toks, emitted, counts = fn(
            *args, self._expert_state())
        if self.ecfg.prefetch:
            self._enqueue_prediction(gids)
            if self._predictors:
                self._enqueue_gate_predictions(holders)
            self._drain_prefetch(gids, retry_refused=True)
        tok = tok.cpu()                                   # sync
        # spans that became resident between dispatch and landing: a miss
        # on them books as hidden, as the reference books it (on the card
        # their copies overlapped only the chunk's tail)
        hidden = {k: ((r.slot_of >= 0) & ~snap[k])
                  for k, r in self.residency.items()}
        for r in self.residency.values():
            r.unpin_all()
        if self.ecfg.prefetch:
            # landed: retry the refused slice, evictions now allowed
            self._drain_prefetch(gids, retry_refused=False)
        if len(gids) > 1:
            self._account_counts(counts, holders=holders, snap=snap,
                                 hidden=hidden)
        else:
            self._account_counts(counts, holder=holders[0], snap=snap,
                                 hidden=hidden)
        return cache, tok, act2, toks, emitted

    def _expert_state(self):
        """The residency data plane for one dispatch, per group: the device
        pool, the (layer, expert) -> slot map written once into its static
        device buffer on the current stream (a snapshot: control-plane
        changes after dispatch cannot reach the chunk, and the chunk reads
        one address however often it runs).  The dispatch waits for the
        pool copies queued before it."""
        if self._copy_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(
                self._copy_stream)
        out = {}
        for k, r in self.residency.items():
            m = torch.from_numpy(r.slot_of)
            if self.device.type == "cuda":
                # a fresh pinned block: the host allocator keeps it until
                # the copy has run
                m = m.pin_memory()
            self._expert_map[k].copy_(m, non_blocking=True)
            out[k] = (self._expert_pool[k], self._expert_map[k])
        return out

    def _copy_span(self, key: str, l: int, e: int, slot: int) -> None:
        """Copy span (l, e) from the host store into pool slot `slot`, on
        the copy stream (asynchronous DMA from pinned memory)."""
        src = self.paged_blocks.expert_pages[key][l, e]
        dst = self._expert_pool[key][slot]
        if self._copy_stream is None:
            dst.copy_(src)
            return
        with torch.cuda.stream(self._copy_stream):
            dst.copy_(src, non_blocking=True)

    def _resident_snap(self) -> Dict[str, np.ndarray]:
        """Residency mask at dispatch time — what the dispatched map says
        is resident; later admissions must not be booked as hits for this
        call's steps."""
        return {k: (r.slot_of >= 0).copy()
                for k, r in self.residency.items()}

    def _account_counts(self, counts, holder=None, snap=None,
                        holders=None, hidden=None) -> None:
        """Book a call's expert activation counts ({key: (..., L, E)}): per
        forward pass, hits/misses against the residency snapshot the pass
        read, then demand-admit the missed spans — hottest first, so the
        miss stream doubles as cache fill.  Updates `holder.pred` with the
        last pass's gating (the router-ahead prediction for that group's
        next chunk).

        ``hidden`` ({key: (L, E) bool}) marks spans whose prefetch landed
        while the call was in flight: a miss on one books as hidden.  Each
        pass also takes one SGD step of the gate predictor, and with
        replication on, the replica set is reconciled (promotions copy
        their spans in).  With ``intra_pass`` the working resident mask
        evolves across the chunk's passes: a demand-missed span streams
        once and counts as staged for the rest of the chunk, and in-flight
        admissions count resident from the second pass on.  This changes
        only when bytes are booked, never what is computed.

        With ``holders`` (a module-batched window) the counts carry a group
        axis ({key: (..., L, G, E)}): each pass books one union
        observation per window (``observe_window``), and each group's
        holder gets its own last-pass prediction."""
        for key, arr in counts.items():
            r = self.residency[key]
            r.begin_chunk()          # refresh the demand-evict victim quota
            a = arr.cpu().numpy()
            mask = snap[key] if snap is not None else None
            hid = hidden.get(key) if hidden is not None else None
            gp = self._predictors.get(key)
            intra = self.ecfg.intra_pass and mask is not None
            cur = mask.copy() if intra else mask
            want: Dict[Tuple[int, int], bool] = {}
            if holders is not None:
                steps = a.reshape(-1, *a.shape[-3:])      # (n_fwd, L, G, E)
                passes = [np.moveaxis(s, 1, 0) for s in steps]  # (G, L, E)
                observe = r.observe_window
            else:
                steps = a.reshape(-1, *a.shape[-2:])      # (n_fwd, L, E)
                passes, observe = steps, r.observe
            for si, s in enumerate(passes):
                if intra and si == 1 and hid is not None:
                    cur = cur | hid   # in-flight admissions have landed
                missed = observe(s > 0, token_counts=s, resident_mask=cur,
                                 hidden_mask=hid)
                for pair in missed:
                    want[pair] = True
                    if intra:
                        cur[pair] = True   # streamed once, staged after
                if gp is not None:
                    for g_counts in (s if holders is not None else [s]):
                        gp.fit_step(g_counts)
            for l, e in want:
                # misses fill free slots only; popularity-driven
                # replacement is the router-ahead prefetch path's job
                slot = r.admit(l, e, demand=True, allow_evict=False)
                if slot is not None:
                    self._copy_span(key, l, e, slot)
            if r.replicate_frac > 0.0:
                for l, e, slot in r.update_replicas():
                    self._copy_span(key, l, e, slot)
            if holder is not None:
                holder.pred[key] = steps[-1] > 0
            if holders is not None:
                for g, h in enumerate(holders):
                    h.pred[key] = steps[-1][:, g, :] > 0

    def _next_gids(self, gids: List[int]) -> List[int]:
        """The rotation groups decoding next: those of the window after
        `gids` (group gid+1 after a lockstep group)."""
        g0 = (max(gids) + 1) % self.ecfg.num_ubs
        return [(g0 + j) % self.ecfg.num_ubs for j in range(len(gids))]

    def _enqueue_prediction(self, gids: List[int]) -> None:
        """Queue the expert sets the next window's groups' routers gated on
        the last step of their previous chunk (the request-level analogue
        of Algorithm 1's j+2 weight lookahead), hottest first."""
        for g in self._next_gids(gids):
            for key, act in self.groups[g].pred.items():
                r = self.residency[key]
                pairs = [(int(l), int(e)) for l, e in zip(*np.nonzero(act))
                         if not r.is_resident(l, e)]
                pairs.sort(key=lambda p: -r.popularity[p])
                for p in pairs:
                    t = (key, *p)
                    if t not in self._pending_set:
                        self._pending.append((*t, "router", None))
                        self._pending_set.add(t)

    def _enqueue_gate_predictions(self, holders) -> None:
        """From each dispatching holder's last gating, the gate predictor
        scores the experts layers i+1..i+lookahead will activate in its
        next chunk; the non-resident ones join the pending queue
        earliest-deadline-first (``paging.predicted_drain_order``), after
        the router-ahead entries and deduped against them.  Their priority
        is the predicted probability times the predictor's accuracy."""
        for h in holders:
            for key, act in h.pred.items():
                gp = self._predictors.get(key)
                if gp is None:
                    continue
                r = self.residency[key]
                preds = gp.predict(act,
                                   lookahead=self.ecfg.predict_lookahead,
                                   topk=self.ecfg.predict_topk)
                pairs = [(l, e) for l, e, _ in preds]
                scores = [s for _, _, s in preds]
                for i in paging.predicted_drain_order(pairs, scores):
                    l, e = pairs[i]
                    if r.is_resident(l, e):
                        continue
                    t = (key, l, e)
                    if t not in self._pending_set:
                        self._pending.append(
                            (*t, "predicted", scores[i] * gp.acc))
                        self._pending_set.add(t)

    def _plan_slice(self, pending: List, gids: List[int]
                    ) -> Tuple[List, List]:
        """The union of these rotation positions' ``paging.transfer_plan``
        slices of a pending transfer queue (``paging.window_plan``; one
        position for a lockstep group); returns (chosen, keep)."""
        take = set(paging.window_plan(len(pending), self.ecfg.num_ubs,
                                      gids))
        chosen = [t for i, t in enumerate(pending) if i in take]
        keep = [t for i, t in enumerate(pending) if i not in take]
        return chosen, keep

    def _drain_prefetch(self, gids: List[int], *,
                        retry_refused: bool) -> None:
        """Copy these rotation positions' slice of the pending prefetch
        queue into the pool.  While a chunk is in flight every resident
        span is pinned, so only free slots fill; refused entries are
        re-queued to retry after the chunk lands (``retry_refused``) or
        dropped (the cache is hotter than the prediction)."""
        if not self._pending:
            return
        chosen, keep = self._plan_slice(self._pending, gids)
        requeued = []
        for key, l, e, cause, pri in chosen:
            r = self.residency[key]
            if r.is_resident(l, e):
                self._pending_set.discard((key, l, e))
                continue
            slot = r.admit(l, e, cause=cause, priority=pri)   # pays bytes
            if slot is not None:
                self._copy_span(key, l, e, slot)
                self._pending_set.discard((key, l, e))
            elif retry_refused:
                requeued.append((key, l, e, cause, pri))
            else:
                self._pending_set.discard((key, l, e))
        self._pending = keep + requeued

    def weight_traffic(self) -> Dict[str, float]:
        """H2D weight traffic, the JAX engine's dict.  The expert-granular
        path moves every layer's shared span each forward pass (through
        the two-slot buffer) plus the missed and prefetched expert spans
        that core.residency booked.  Per phase: ``attn_phase_bytes`` are the
        shared spans, once per forward pass (a window's pass serves all its
        groups), ``expert_phase_bytes`` the expert spans (misses and
        prefetches); ``module_groups_effective`` is the measured
        amortization, lockstep-equivalent misses over per-window union
        misses."""
        out: Dict[str, float] = {"fwd_passes": self._fwd_passes,
                                 "tokens_out": self.tokens_out,
                                 "module_batch": self._mg > 1,
                                 "module_groups": self._mg}
        if not self.residency:
            out.update(mode="resident", h2d_bytes=0, attn_phase_bytes=0,
                       expert_phase_bytes=0,
                       module_groups_effective=float(self._mg))
            out["bytes_per_token_amortized"] = 0 / max(1, self.tokens_out)
            return out
        pw = self.paged_blocks
        shared = sum(pw.shared_layer_bytes(k) * pw.manifests[k].num_layers
                     for k in pw.manifests)
        expert_full = sum(em.span_bytes * em.num_experts * em.num_layers
                          for em in pw.expert_manifests.values())
        c = [r.counters for r in self.residency.values()]
        misses = sum(x.misses for x in c)
        lockstep = sum(x.lockstep_misses for x in c)
        pred_pf = sum(x.predicted_prefetches for x in c)
        out.update(
            mode="expert_paged",
            shared_bytes=shared * self._fwd_passes,
            expert_bytes=sum(x.h2d_bytes for x in c),
            hits=sum(x.hits for x in c),
            misses=misses,
            prefetches=sum(x.prefetches for x in c),
            evictions=sum(x.evictions for x in c),
            hit_rate=(sum(x.hits for x in c)
                      / max(1, sum(x.fetches for x in c))),
            demand_hits=sum(x.demand_hits for x in c),
            router_hits=sum(x.router_hits for x in c),
            predicted_hits=sum(x.predicted_hits for x in c),
            replicated_hits=sum(x.replicated_hits for x in c),
            predicted_prefetches=pred_pf,
            predicted_used=sum(x.predicted_used for x in c),
            prefetch_accuracy=(sum(x.predicted_used for x in c)
                               / max(1, pred_pf)),
            predictor_accuracy=(
                float(np.mean([gp.acc for gp in self._predictors.values()]))
                if self._predictors else 0.0),
            replications=sum(x.replications for x in c),
            replica_spans=sum(len(r.replicas)
                              for r in self.residency.values()),
            hidden_misses=sum(x.hidden_misses for x in c),
            stall_misses=sum(x.stall_misses for x in c),
            miss_stall_bytes=int(sum(r.miss_stall_bytes.sum()
                                     for r in self.residency.values())),
            miss_stall_bytes_per_layer={
                k: [int(b) for b in r.miss_stall_bytes]
                for k, r in self.residency.items()},
            # what whole-layer streaming would have moved for the same
            # passes (shared + every expert span every layer)
            whole_layer_bytes=(shared + expert_full) * self._fwd_passes,
            module_groups_effective=(lockstep / misses if misses
                                     else float(self._mg)),
        )
        out["h2d_bytes"] = out["shared_bytes"] + out["expert_bytes"]
        out["attn_phase_bytes"] = out["shared_bytes"]
        out["expert_phase_bytes"] = out["expert_bytes"]
        out["bytes_per_token_amortized"] = (out["h2d_bytes"]
                                            / max(1, self.tokens_out))
        return out

    # ------------------------------ block-granular paged KV (data+control)
    def _slot_of(self, slot) -> int:
        return slot.gid * self.ecfg.ubatch + slot.row

    def _compose_kv(self, dense_cache: Dict, gids: List[int]) -> Dict:
        """The dispatch cache of the slot groups `gids` (one, or a
        window's, its page table covering every window row, group-major):
        the dense part plus the shared arena and the page table, built on
        the host from the BlockPool and copied to the device once, shared
        by every layer (a broadcast view over the layer axis)."""
        b = self.ecfg.ubatch
        pt = torch.from_numpy(self._kv.device_table(
            [g * b + r for g in gids for r in range(b)])).to(self.device)
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

    def _kv_sweep(self) -> None:
        """Release the arena and host blocks of any slot that fell back to
        FREE outside the engine's own retire path (budget preemption)."""
        for grp in self.scheduler.slots:
            for s in grp:
                if s.state == SlotState.FREE:
                    idx = self._slot_of(s)
                    if self._kv.slot_in_use(idx):
                        self._kv.free_slot(idx)

    def _kv_prepare_group(self, gids: List[int], chunk: int) -> None:
        """Pre-dispatch guard for the paged pool: every decoding row's
        mapped blocks must be device-resident (attention reads its whole
        history) and the blocks its next `chunk` tokens will write must be
        mapped.  Cold blocks of other slots spill to the host tier to make
        room; on arena exhaustion the youngest decoding request in the
        group is preempted (recompute preemption — blocks freed, request
        re-queued with its transcript intact).  Retries resume each slot
        at its first unsatisfied block, so every needed block books exactly
        one hit or miss per preparation.  A window's groups dispatch in one
        call, so the protect set spans the whole window (preparing a later
        group never spills an earlier one's just-prepared blocks)."""
        slots = [s for g in gids for s in self.scheduler.slots[g]]
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

    def _kv_enqueue_prefetch(self, gids: List[int]) -> None:
        """Queue the next window's spilled blocks (the KV analogue of
        Algorithm 1's weight lookahead; group gid+1's after a lockstep
        group)."""
        for g in self._next_gids(gids):
            for s in self.scheduler.slots[g]:
                if s.state != SlotState.DECODE:
                    continue
                idx = self._slot_of(s)
                for lb in self._kv.host_resident_blocks(idx):
                    t = (idx, lb)
                    if t not in self._kv_pending_set:
                        self._kv_pending.append(t)
                        self._kv_pending_set.add(t)

    def _kv_drain_prefetch(self, gids: List[int]) -> None:
        """Promote these rotation positions' ``paging.transfer_plan``
        slices of the pending block queue into free arena blocks (no
        demotions on the prefetch path); entries that became stale or
        found no free block fall back to the demand path."""
        if not self._kv_pending:
            return
        chosen, self._kv_pending = self._plan_slice(self._kv_pending, gids)
        self._kv_pending_set.difference_update(chosen)
        for idx, lb in chosen:
            op = self._kv.prefetch(idx, lb)
            if op is not None:
                self._kv_exec([op])

    def _kv_note_gather(self, gids: List[int], steps: int) -> None:
        """Book the decode-path KV gather of one dispatched chunk (of a
        group or a window): the paged kernel reads each row's mapped
        blocks once per decode step (per layer), so gathered bytes scale
        with the page table's mapped blocks, not with ``max_seq``."""
        b = self.ecfg.ubatch
        rows = [g * b + r for g in gids for r in range(b)]
        mapped = sum(self._kv.n_mapped(r) for r in rows)
        self._kv_gather_steps += steps
        self._kv_gathered_blocks += mapped * steps
        self._kv_view_blocks += len(rows) * self._kv.blocks_per_slot * steps

    def kv_traffic(self) -> Dict[str, float]:
        """Device-KV accounting: bytes the KV pool occupies on the device
        against the dense max_seq-wide equivalent, plus, for the paged
        pool, the host-tier stream counters (bytes the planned spills and
        fetches copied)."""
        out: Dict[str, float] = dict(tokens_out=self.tokens_out,
                                     dense_equiv_bytes=self._kv_dense_bytes)
        if self._kv is None:
            out.update(mode="kv_dense", device_kv_bytes=self._kv_dense_bytes,
                       h2d_bytes=0, d2h_bytes=0)
            return out
        c = self._kv.counters
        out.update(
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
            hit_rate=c.hit_rate)
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
