"""Continuous-batching inference engine of the PyTorch port: the
``mode="continuous"`` subset of ``repro/serving/engine.py`` with resident
weights and the dense KV ring.

  * one persistent KV pool of ``num_ubs × ubatch`` slots is allocated at
    construction — ``num_ubs`` rotation groups of ``ubatch`` batch rows.  A
    slot is one row of one group's cache, recycled in place
    (``kvcache.insert_slot``) without touching its neighbours;
  * the Scheduler (a copy of the JAX package's) tracks each slot's
    lifecycle (free → prefilling → decoding → drained) and admits single
    requests into freed slots via Algorithm 2's balance criterion;
  * admission prefills a request at batch 1 and a bucketed prompt width,
    then copies its KV row into the pool;
  * decode runs one fixed-shape masked chunk of ``decode_chunk`` tokens per
    rotation group (``steps.make_decode_chunk``): finished rows are masked,
    emit nothing and keep their cache position.

Greedy transcripts equal the JAX engine's on the same weights (the parity
tests hold the two against each other).  Paged weights, the expert-paged and
paged-KV paths, overlapped admission, module batching, static mode and the
fault plane are later slices, and so are sampling at a temperature, EOS-aware
reservations with preemption and long-prompt truncation: ``EngineConfig``
keeps the JAX package's names for the fields it has, and has no others.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
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


class _SlotGroup:
    """Device-side state of one rotation group: its slice of the KV pool,
    plus the last sampled token per row (the next decode input)."""

    def __init__(self, cache, ubatch: int):
        self.cache = cache
        self.last_tok = np.zeros((ubatch,), np.int32)


def _to_device(tree: Dict, device: torch.device) -> Dict:
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device))
            for k, v in tree.items()}


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig,
                 policy: Optional[ExecPolicy] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.ecfg = ecfg
        self.policy = policy
        self.scheduler = Scheduler(ubatch=ecfg.ubatch, num_ubs=ecfg.num_ubs,
                                   max_seq=ecfg.max_seq)
        self._prefill = serve_steps.make_prefill_fill_step(cfg, policy)
        self._decode_chunk = serve_steps.make_decode_chunk(
            cfg, policy, eos_id=ecfg.eos_id, chunk=ecfg.decode_chunk)
        # the persistent slot pool: allocated once, recycled per slot
        self.groups: List[_SlotGroup] = [
            _SlotGroup(kvcache.init_cache(cfg, ecfg.ubatch, ecfg.max_seq,
                                          device=self.device), ecfg.ubatch)
            for _ in range(ecfg.num_ubs)]
        # batch-1 admission-prefill cache, reset before every admission
        self._prefill_scratch = kvcache.init_cache(cfg, 1, ecfg.max_seq,
                                                   device=self.device)
        self.steps = 0
        self.tokens_out = 0

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
        bucket width (batch 1) and copy the KV into the pool row."""
        for slot in self.scheduler.admit_to_slots():
            r = slot.req
            S = self._bucket(r.input_len)
            toks = np.zeros((1, S), np.int32)
            toks[0, :r.input_len] = r.prompt
            scratch = kvcache.reset_slot(self._prefill_scratch, 0)
            logits, single = self._prefill(
                self.params, torch.as_tensor(toks, device=self.device),
                scratch, torch.tensor([r.input_len], dtype=torch.int32,
                                      device=self.device))
            first = int(sample(logits)[0])
            r.generated.append(first)
            group = self.groups[slot.gid]
            kvcache.insert_slot(group.cache, single, slot.row)
            group.last_tok[slot.row] = first
            if len(r.generated) >= r.max_new_tokens:
                self.scheduler.finish(slot)      # quota met at prefill
            else:
                self.scheduler.start_decode(slot)

    def _tick_group(self, gid: int) -> None:
        """One rotation group's masked decode chunk."""
        group = self.groups[gid]
        slots = self.scheduler.slots[gid]
        active = np.array([s.state == SlotState.DECODE for s in slots])
        if not active.any():
            return
        rem = np.array(
            [s.req.remaining if s.state == SlotState.DECODE else 0
             for s in slots], np.int32)
        dev = self.device
        cache, tok, act2, _, toks, emitted = self._decode_chunk(
            self.params, group.cache,
            torch.as_tensor(group.last_tok[:, None], device=dev),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(rem, device=dev))
        group.cache = cache
        group.last_tok = tok[:, 0].cpu().numpy()          # sync
        act2 = act2.cpu().numpy()
        self.tokens_out += self._emit(
            toks.cpu().numpy(), emitted.cpu().numpy(),
            [s.req if s.state == SlotState.DECODE else None for s in slots])
        # no cache reset on finish: the row stays masked while free, and the
        # next admission's insert_slot overwrites every leaf of the row
        for i, s in enumerate(slots):
            if s.state == SlotState.DECODE and not act2[i]:
                self.scheduler.finish(s)
