"""Serving step functions of the PyTorch port (``repro/serving/steps.py``):
the admission prefill (batch 1 in continuous mode, a whole micro-batch in
static mode), its chunked form for overlapped admission
(``prefill_chunk``) and the masked multi-token ``decode_chunk`` of the
slot-pool engine (a chunk of 1 in static mode).  Prefill, monolithic or
chunked, runs on a dense cache; the paged pool is written by the slot
inserts.  ``make_serve_step`` is the plain greedy decode step that a
sharding plan's policy runs (``distributed.sharding.make_plan``); the
reference's ``make_prefill_step`` is not ported: no ported module calls
it.

Whole-layer paged weights (a ``core.paging.PagedWeights`` without expert
manifests as ``paged_blocks``) change nothing here: the forward streams
each layer through a two-slot device buffer.

Expert-granular paging (a ``core.paging.PagedWeights`` with expert
manifests as ``paged_blocks``) changes the step signatures: each step takes
a trailing ``expert_state`` ({key: (pool, resident_map)} — the device
residency snapshot) and returns the per-layer expert activation counts, so
that the engine's host-side residency cache can learn popularity and
account traffic.  ``_expert_granular`` decides which shape a factory
makes."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paging
from repro_torch.models.model import ExecPolicy, forward, unembed
from repro_torch.serving.sampling import sample


def _expert_granular(paged_blocks) -> bool:
    return (isinstance(paged_blocks, paging.PagedWeights)
            and bool(paged_blocks.expert_manifests))


def make_serve_step(cfg: ModelConfig,
                    policy: Optional[ExecPolicy] = None) -> Callable:
    """One greedy decode step: (params, cache, tokens (B,1)) ->
    (next_token (B,) int32, logits (B,V) f32, cache), the cache written in
    place and returned.  Under a plan over more than one rank, B is this
    rank's rows over the dp axes and the logits are whole, gathered over
    the vocabulary's axes."""

    def serve_step(params, cache, tokens):
        out = forward(cfg, params, tokens, cache=cache, mode="decode",
                      policy=policy)
        logits = unembed(cfg, params, out["hidden"][:, -1],
                         shard=policy.shard if policy else None)
        return (torch.argmax(logits, dim=-1).to(torch.int32), logits,
                out["cache"])

    return serve_step


def make_prefill_fill_step(cfg: ModelConfig,
                           policy: Optional[ExecPolicy] = None, *,
                           paged_blocks=None) -> Callable:
    """(params, tokens (B,S), cache, lens (B,)) -> (logits (B,V), cache).
    Writes the prompt's KV into `cache` (in place).  `lens` are the true
    prompt lengths: logits are taken at each row's own final position and
    the cache's pos is set per row, and the SSM layers carry their state
    from each row's true length (``forward``'s ``lens``).  Expert-granular:
    a trailing ``expert_state`` argument, and the counts {key: (L, E)} as a
    third output."""

    expert = _expert_granular(paged_blocks)

    def prefill_step(params, tokens, cache, lens, expert_state=None):
        out = forward(cfg, params, tokens, cache=cache, mode="prefill",
                      policy=policy, paged_blocks=paged_blocks,
                      expert_state=expert_state, lens=lens)
        cache = out["cache"]
        cache["pos"] = lens.to(torch.int32)
        idx = torch.clamp(lens - 1, min=0).long()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        logits = unembed(cfg, params, out["hidden"][rows, idx])
        if expert:
            return logits, cache, out["expert_counts"]
        return logits, cache

    return prefill_step


def make_prefill_chunk(cfg: ModelConfig, policy: Optional[ExecPolicy] = None,
                       *, paged_blocks=None) -> Callable:
    """Chunked-prefill admission step (the overlap path): one fixed-width
    chunk of a prompt at the offset in cache["pos"], its KV written into
    the ring (in place), its logits taken at its last true position.

    (params, tokens (B,C), cache, fill_len (B,) int32) -> (logits, cache)

    `fill_len` is the chunk's true token count (< C only for the final
    chunk), so the call covering the end of the prompt yields the logits
    a monolithic prefill gives there.  The cache's pos advances by
    fill_len.  Expert-granular: a trailing ``expert_state`` argument, and
    the counts {key: (L, E)} as a third output."""

    expert = _expert_granular(paged_blocks)

    def prefill_chunk(params, tokens, cache, fill_len, expert_state=None):
        out = forward(cfg, params, tokens, cache=cache, mode="chunk_prefill",
                      policy=policy, paged_blocks=paged_blocks,
                      fill_len=fill_len, expert_state=expert_state)
        idx = torch.clamp(fill_len - 1, min=0).long()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        logits = unembed(cfg, params, out["hidden"][rows, idx])
        if expert:
            return logits, out["cache"], out["expert_counts"]
        return logits, out["cache"]

    return prefill_chunk


def make_decode_chunk(cfg: ModelConfig, policy: Optional[ExecPolicy] = None,
                      *, paged_blocks=None, temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      eos_id: int = 1, chunk: int = 8,
                      token_groups: Optional[int] = None) -> Callable:
    """Masked multi-token decode for the slot-pool engine: `chunk` decode
    steps with a per-row *active* mask, so drained / free slots are carried
    along at fixed shape without emitting tokens or advancing their cache
    position.

    (params, cache, tok (B,1), active (B,) bool, rem (B,) int32)
    -> (cache, tok, active, rem, toks (chunk,B) int32, emitted (chunk,B) bool)

    Per step, an active row samples its token (greedy at temperature 0,
    else from ``softmax(logits / temperature)`` with uniforms drawn from
    `generator`, the engine's), decrements its remaining quota, and goes
    inactive on EOS or quota exhaustion; `emitted` marks
    exactly the (step, row) pairs whose token belongs to a request.
    Inactive rows keep their `pos`; the fixed-shape forward still writes KV
    at their frozen `pos % W` slot, so a drained row's cache is garbage
    until the next admission's `insert_slot` overwrites it.  Every shape is
    fixed and nothing is read back to the host inside the chunk, so a later
    change can capture it as a CUDA graph.

    Expert-granular paging adds a trailing ``expert_state`` argument (the
    residency snapshot, constant across the chunk) and a trailing
    ``counts`` output ({key: (chunk, L, E)}, per step, so the host books
    each step's activations against the snapshot it read).

    token_groups=G (module-based batching): B is G·ubatch, group-major —
    the engine concatenates G rotation groups' slot caches, and the MoE
    FFN stages all G groups' routed tokens against one expert-span read
    per layer step; counts then gains a group axis ({key: (chunk, L, G,
    E)})."""

    expert = _expert_granular(paged_blocks)

    def decode_chunk(params, cache, tok, active, rem, expert_state=None):
        toks, emits, counts = [], [], []
        for _ in range(chunk):
            pos0 = cache["pos"]
            out = forward(cfg, params, tok, cache=cache, mode="decode",
                          policy=policy, paged_blocks=paged_blocks,
                          expert_state=expert_state,
                          token_groups=token_groups)
            logits = unembed(cfg, params, out["hidden"][:, -1],
                             token_groups)
            nxt = sample(logits, generator, temperature=temperature)
            cache = out["cache"]
            cache["pos"] = torch.where(active, cache["pos"], pos0)
            emitted = active
            rem = rem - emitted.to(torch.int32)
            active = active & (nxt != eos_id) & (rem > 0)
            tok = torch.where(emitted, nxt, tok[:, 0])[:, None]
            toks.append(nxt)
            emits.append(emitted)
            if expert:
                counts.append(out["expert_counts"])
        res = (cache, tok, active, rem, torch.stack(toks), torch.stack(emits))
        if expert:
            return res + ({k: torch.stack([c[k] for c in counts])
                           for k in counts[0]},)
        return res

    return decode_chunk
