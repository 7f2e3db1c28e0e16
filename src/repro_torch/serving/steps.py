"""Serving step functions of the PyTorch port (``repro/serving/steps.py``):
the batch-1 admission prefill and the masked multi-token ``decode_chunk``
of the continuous-batching engine."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import ExecPolicy, forward, unembed
from repro_torch.serving.sampling import sample


def make_prefill_fill_step(cfg: ModelConfig,
                           policy: Optional[ExecPolicy] = None) -> Callable:
    """(params, tokens (B,S), cache, lens (B,)) -> (logits (B,V), cache).
    Writes the prompt's KV into `cache` (in place).  `lens` are the true
    prompt lengths: logits are taken at each row's own final position and
    the cache's pos is set per row."""

    def prefill_step(params, tokens, cache, lens):
        out = forward(cfg, params, tokens, cache=cache, mode="prefill",
                      policy=policy)
        cache = out["cache"]
        cache["pos"] = lens.to(torch.int32)
        idx = torch.clamp(lens - 1, min=0).long()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        logits = unembed(cfg, params, out["hidden"][rows, idx])
        return logits, cache

    return prefill_step


def make_decode_chunk(cfg: ModelConfig, policy: Optional[ExecPolicy] = None,
                      *, eos_id: int = 1, chunk: int = 8) -> Callable:
    """Masked multi-token decode for the slot-pool engine: `chunk` decode
    steps with a per-row *active* mask, so drained / free slots are carried
    along at fixed shape without emitting tokens or advancing their cache
    position.

    (params, cache, tok (B,1), active (B,) bool, rem (B,) int32)
    -> (cache, tok, active, rem, toks (chunk,B) int32, emitted (chunk,B) bool)

    Per step, an active row takes its greedy token, decrements its remaining
    quota, and goes inactive on EOS or quota exhaustion; `emitted` marks
    exactly the (step, row) pairs whose token belongs to a request.
    Inactive rows keep their `pos`; the fixed-shape forward still writes KV
    at their frozen `pos % W` slot, so a drained row's cache is garbage
    until the next admission's `insert_slot` overwrites it.  Every shape is
    fixed and nothing is read back to the host inside the chunk, so a later
    change can capture it as a CUDA graph."""

    def decode_chunk(params, cache, tok, active, rem):
        toks, emits = [], []
        for _ in range(chunk):
            pos0 = cache["pos"]
            out = forward(cfg, params, tok, cache=cache, mode="decode",
                          policy=policy)
            logits = unembed(cfg, params, out["hidden"][:, -1])
            nxt = sample(logits)
            cache = out["cache"]
            cache["pos"] = torch.where(active, cache["pos"], pos0)
            emitted = active
            rem = rem - emitted.to(torch.int32)
            active = active & (nxt != eos_id) & (rem > 0)
            tok = torch.where(emitted, nxt, tok[:, 0])[:, None]
            toks.append(nxt)
            emits.append(emitted)
        return cache, tok, active, rem, torch.stack(toks), torch.stack(emits)

    return decode_chunk
