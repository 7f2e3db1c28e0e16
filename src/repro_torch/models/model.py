"""Model assembly of the PyTorch port (``repro/models/model.py``):
embedding → prologue blocks → periodic blocks → final norm → unembed, for
every family of the reference: GQA and MLA attention, or a Mamba-2 mixer,
with dense or MoE FFNs; whisper's encoder, whose output the decoder
blocks cross-attend; paligemma's prefix of patch embeddings.

JAX's ``lax.scan`` over the stacked layers becomes a Python loop over layer
slices: each layer's parameters and cache are views into the stacked
tensors, so the ring writes of a layer land in the stacked cache.

With paged weights (``paged_blocks``, a ``core.paging.PagedWeights`` in
host stores) the blocks' parameters are not on the device: each layer's
span streams through a two-slot device buffer, layer i+1's copy running on
a copy stream while layer i computes (``_SpanStream``, the Appendix A.1
double buffer).  Whole-layer paging streams every leaf of the layer that
way; on the expert-granular path the span holds the shared leaves
(attention, norms, router) and the MoE FFN fetches only the activated
experts' spans per layer (``_ExpertCtx``).  The schedule is fixed by the
layer index and ordered by CUDA events, so nothing is read back to the
host.

Execution strategy is injected through an `ExecPolicy`, as in the JAX
package; a sharding plan's policy also carries the expert-parallel MoE body
(``moe_fn``), the sequence-sharded decode attention (``attn_fn``) and
``remat``, which in a train forward runs each block under
``torch.utils.checkpoint``.  The reference's ``remat`` never takes effect:
its check compares the scan's mode, never "train", with "train"
(``repro/models/model.py:229``).  A plan over more than one rank also sets
``shard`` (``distributed.tensor_parallel.ShardCtx``): each rank then runs
the step on its slices, the attention on its heads, the dense FFN on its
slice of ``ffn``, the vocabulary on its rows, and gathers a leaf split
over the data axes (FSDP) at its use.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import offload, paging
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels import ops
from repro_torch.models.attention import attn_forward, gqa_forward
from repro_torch.models.common import (act_fn, apply_norm, by_group,
                                       sinusoidal_positions, softcap)
from repro_torch.models.mamba import mamba_forward
from repro_torch.models.moe import gated_ffn, moe_apply, moe_apply_paged


@dataclass
class ExecPolicy:
    """How to execute (not what to compute).  ``moe_fn``, ``attn_fn`` and
    ``remat`` are set by a sharding plan (``distributed.sharding``)."""
    moe_impl: str = "dense"               # dense | grouped
    use_kernels: bool = False             # grouped MoE FFN through moe_ffn
    impl: str = "auto"                    # kernel dispatch (kernels/ops.py):
    # auto (the CUDA kernels on CUDA tensors, plain PyTorch on CPU) | ref
    # (the kernels' plain versions everywhere)
    moe_fn: Optional[Callable] = None     # overrides moe_impl when set
    attn_fn: Optional[Callable] = None    # sequence-sharded decode attention
    remat: bool = False                   # train: each block recomputed in
    # the backward (torch.utils.checkpoint)
    shard: Optional[Any] = None           # tensor_parallel.ShardCtx of a
    # plan over more than one rank


@dataclass
class _ExpertCtx:
    """Per-forward state for one group's expert-granular paged weights: the
    host page store, its manifest, and the device residency pool + (layer,
    expert) -> slot map snapshot."""
    pages: Any                            # (L, E, ppe, page_elems) host store
    manifest: Any                         # paging.ExpertManifest
    pool: Optional[Any] = None            # (slots, ppe, page_elems) device
    resident_map: Optional[Any] = None    # (L, E) int32, -1 = host only
    impl: str = "auto"

    def make_fetch(self, layer: int):
        """Bind the layer: fetch(sel (A,), n_act) gathers the activated
        experts' spans — resident ones from the pool, misses from the
        pinned host store on the copy engine — as the compacted (A, ...)
        expert params (``kernels.ops.expert_gather``; on the card it waits
        for the device to reach the gather, once per call)."""

        def fetch(sel, n_act):
            rmap = self.resident_map
            if rmap is None:
                rmap = torch.full((self.manifest.num_layers,
                                   self.manifest.num_experts), -1,
                                  dtype=torch.int32, device=sel.device)
            return ops.expert_gather(self.pages, self.pool, rmap, layer, sel,
                                     n_act, self.manifest, impl=self.impl)

        return fetch


class _SpanStream:
    """One group's layer spans (whole layers, or their shared leaves on the
    expert-granular path) through a two-slot device buffer (the
    ``paging.DoubleBuffer`` of Appendix A.1): layer i+1's span is copied on
    the copy stream while layer i computes out of the other slot.  Events
    order it: a slot is refilled only after the layer that read it is done,
    and a layer waits for its span.  On the CPU the copies are plain."""

    def __init__(self, pages, manifest, device: torch.device):
        self.pages, self.manifest = pages, manifest
        self.db = paging.DoubleBuffer()
        self.buf = torch.empty((2,) + tuple(pages.shape[1:]),
                               dtype=pages.dtype, device=device)
        self.stream = offload.copy_stream(device)
        self.ready, self.done = {}, {}
        if self.stream is not None:
            # the buffer may be memory the current stream just freed
            self.stream.wait_stream(torch.cuda.current_stream(device))
        self._issue(0)

    def _issue(self, layer: int) -> None:
        if layer >= len(self.pages):
            return
        slot = self.db.load(layer)
        if self.stream is None:
            self.buf[slot].copy_(self.pages[layer])
            return
        with torch.cuda.stream(self.stream):
            if layer - 2 in self.done:
                self.stream.wait_event(self.done.pop(layer - 2))
            self.buf[slot].copy_(self.pages[layer], non_blocking=True)
            self.ready[layer] = torch.cuda.Event()
            self.ready[layer].record(self.stream)

    def params(self, layer: int) -> Dict:
        """Layer `layer`'s params (views into its buffer slot), once its
        span has landed; issues the next layer's copy."""
        self._issue(layer + 1)
        if self.stream is not None:
            torch.cuda.current_stream().wait_event(self.ready.pop(layer))
        return paging.unflatten_span(self.buf[self.db.slot_for(layer)],
                                     self.manifest)

    def release(self, layer: int) -> None:
        """Layer `layer`'s compute is enqueued: its slot may be refilled
        after it."""
        if self.stream is not None:
            self.done[layer] = torch.cuda.Event()
            self.done[layer].record(torch.cuda.current_stream())


def dense_ffn(cfg: ModelConfig, p: Dict, x, shard=None):
    """A dense FFN; under ``shard``, on this rank's slice of its ``ffn``
    dim (``tensor_parallel.ffn_local``)."""
    d_ff = cfg.dense_d_ff or cfg.d_ff
    if cfg.ffn_act == "gelu_mlp":
        y = TP.ffn_local(shard, p, x, d_ff, lambda p, x: torch.matmul(
            act_fn("gelu_mlp")(torch.matmul(x, p["wi"].to(x.dtype))
                               + p["bi"].to(x.dtype)), p["wo"].to(x.dtype)))
        return y + p["bo"].to(x.dtype)
    return TP.ffn_local(shard, p, x, d_ff,
                     lambda p, x: gated_ffn(cfg, p["wi"], p["wo"], x))


def block_apply(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, *, positions,
                cache: Optional[Dict], mode: str, pos,
                policy: Optional[ExecPolicy], expert_fetch=None,
                token_groups: Optional[int] = None, lens=None,
                causal: bool = True, enc_out=None, xattn_cache=None,
                key: Optional[str] = None):
    """One layer.  Returns (x, aux_loss, expert_counts); a given cache is
    written in place.  With ``expert_fetch`` (expert-granular paged
    weights) the MoE FFN runs the two-phase step and expert_counts (E,)
    reports the routing; otherwise it is None.

    token_groups=G (module-based batching): the batch concatenates G
    rotation groups.  Attention, the norms and a dense FFN run group by
    group (``common.by_group``), attention on each group's rows of the
    cache, so every row computes as in its lockstep dispatch (on the card
    an RMSNorm's row sums, too, change bits with the row count); the MoE
    FFN stages the G groups' routed tokens into one buffer, and
    expert_counts becomes (G, E).  A mamba layer's mixer runs group by
    group as attention does, on each group's rows of the SSM cache.

    lens ((B,) integer, prefill): each row's true length, for the SSM
    state and conv tails (attention masks the padded tail by slot_pos).

    causal=False: the self-attention sees every position (whisper's
    encoder).  A cross-attention layer (``spec.cross_attn``) attends its
    queries to the encoder's positions: outside decode it projects K and
    V from ``enc_out`` (B, encS, E) and, given ``xattn_cache`` (this
    layer's ``{"k", "v"}`` of ``cache["xattn"]``), writes them there; in
    decode it reads them from there.

    key: the layer's stack (``"p0"``, ``"prologue"``), under a plan's
    ``shard`` to gather its leaves split over the data axes (FSDP)."""
    aux, ecounts = 0.0, None
    shard = policy.shard if policy is not None else None
    if shard is not None:
        p = shard.gather_fsdp(p, ("prologue", "p0") if key == "prologue"
                              else ("blocks", key), stacked=True)

    def mix(x, cache):
        h = apply_norm(cfg, p.get("mamba_norm", {}), x)
        return x + mamba_forward(cfg, p["mamba"], h, cache=cache, mode=mode,
                                 lens=lens)

    def attend(x, positions, cache, pos):
        h = apply_norm(cfg, p.get("attn_norm", {}), x)
        y, _ = attn_forward(cfg, spec, p["attn"], h, positions, cache=cache,
                            mode=mode, pos=pos, causal=causal,
                            impl=policy.impl if policy else "auto",
                            attn_fn=policy.attn_fn if policy else None,
                            shard=shard)
        if cfg.post_block_norm:
            y = apply_norm(cfg, p["post_attn_norm"], y)
        return x + y

    if spec.kind == "mamba":
        x = by_group(mix, token_groups, x, cache)
    else:
        x = by_group(attend, token_groups, x, positions, cache, pos)
    if spec.cross_attn:
        x = x + cross_attend(cfg, p, x, positions, mode=mode,
                             enc_out=enc_out, xattn_cache=xattn_cache,
                             impl=policy.impl if policy else "auto")
    if spec.ffn:
        h = by_group(lambda x: apply_norm(cfg, p.get("ffn_norm", {}), x),
                     token_groups, x)
        if spec.moe and expert_fetch is not None:
            y, aux, ecounts = moe_apply_paged(cfg, p["moe"], h, expert_fetch,
                                              policy,
                                              token_groups=token_groups)
        elif spec.moe:
            y, aux = moe_apply(cfg, p["moe"], h, policy,
                               token_groups=token_groups)
        else:
            y = by_group(lambda h: dense_ffn(cfg, p["ffn"], h, shard),
                         token_groups, h)
        if cfg.post_block_norm:
            y = by_group(lambda y: apply_norm(cfg, p["post_ffn_norm"], y),
                         token_groups, y)
        x = x + y
    return x, aux, ecounts


def _remat_block(*args, **kw):
    """``block_apply`` under ``torch.utils.checkpoint``: its activations
    are not kept for the backward but recomputed there (what
    ``jax.checkpoint`` of the scanned body is in the reference)."""
    return checkpoint(block_apply, *args, use_reentrant=False, **kw)


def cross_attend(cfg: ModelConfig, p: Dict, x, positions, *, mode: str,
                 enc_out, xattn_cache: Optional[Dict], impl: str = "auto"):
    """A decoder layer's cross-attention output (before the residual add).
    The encoder's K and V are projected once, by the train or prefill
    forward, and persisted in ``xattn_cache``; each decode step reads them
    (one query row over the encoder's positions)."""
    h = apply_norm(cfg, p["xattn_norm"], x)
    if mode == "decode":
        k, v = xattn_cache["k"], xattn_cache["v"]
    else:
        B, Se, _ = enc_out.shape
        shape = (B, Se, cfg.num_kv_heads, cfg.head_dim)
        k = torch.matmul(enc_out, p["xattn"]["wk"].to(enc_out.dtype))
        v = torch.matmul(enc_out, p["xattn"]["wv"].to(enc_out.dtype))
        k, v = k.reshape(shape), v.reshape(shape)
        if xattn_cache is not None:     # persist for decode
            xattn_cache["k"].copy_(k)
            xattn_cache["v"].copy_(v)
    y, _ = gqa_forward(cfg, LayerSpec(), p["xattn"], h, positions,
                       cache=None, mode="full", kv_override=(k, v),
                       impl=impl)
    return y


def _table(params, shard, name: str):
    """The embedding table ("tokens") or the LM head, FSDP-gathered under
    ``shard``."""
    w = params["lm_head"] if name == "lm_head" else params["embed"]["tokens"]
    if shard is None:
        return w
    path = ("lm_head",) if name == "lm_head" else ("embed", "tokens")
    return shard.gather_fsdp(w, path, stacked=False)


def embed_tokens(cfg: ModelConfig, params, tokens, positions, patches=None,
                 shard=None):
    """Token embeddings (B,S,E): scaled where the config says so, the first
    ``min(vision_tokens, S)`` rows then overwritten by the unscaled patch
    embeddings (paligemma's prefix), and the sinusoidal stand-in for
    learned positions added at the tokens' absolute ``positions``
    (whisper).  Under ``shard`` from this rank's rows of the table
    (``tensor_parallel.embed_lookup``)."""
    table = _table(params, shard, "tokens")
    if shard is not None and table.shape[0] != cfg.vocab_size:
        x = TP.embed_lookup(shard, table, tokens)
    else:
        x = table[tokens]                            # (B,S,E) gather
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.vision_tokens and patches is not None:
        nv = min(cfg.vision_tokens, x.shape[1])
        x = torch.cat([patches[:, :nv].to(x.dtype), x[:, nv:]], dim=1)
    if cfg.pos == "learned":                         # sinusoidal stand-in
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def encoder_forward(cfg: ModelConfig, params, frames,
                    policy: Optional[ExecPolicy] = None):
    """whisper's encoder over frames (B, encS, E) (the conv frontend is
    stubbed): sinusoidal positions 0..encS-1, the encoder blocks with
    non-causal self-attention, then the encoder's final norm."""
    B, S, E = frames.shape
    positions = torch.arange(S, device=frames.device)[None].expand(B, S)
    x = frames + sinusoidal_positions(positions, E).to(frames.dtype)
    enc = params["encoder"]
    spec = LayerSpec(cross_attn=False)
    for layer in range(cfg.encoder_layers):
        x, _, _ = block_apply(cfg, spec,
                              paging.layer_slice(enc["blocks"]["p0"], layer),
                              x, positions=positions, cache=None,
                              mode="full", pos=None, policy=policy,
                              causal=False)
    return apply_norm(cfg, enc["final_norm"], x)


def forward(cfg: ModelConfig, params, tokens, *, cache=None, mode="train",
            frames=None, patches=None,
            policy: Optional[ExecPolicy] = None, paged_blocks=None,
            expert_state=None, fill_len=None, lens=None,
            token_groups: Optional[int] = None):
    """tokens: (B,S) integer.  mode: train | prefill | decode |
    chunk_prefill.  Returns dict(hidden, cache, aux_loss); call `unembed`
    for logits.

    prefill writes the prompt's KV into the cache ring at positions 0..S-1;
    decode reads and writes it at each row's ``cache["pos"]``.  The cache
    is updated in place and returned (its "pos" advances by S, or 1).
    The prologue's layers (``params["prologue"]["p0"]``, with their dense
    rings in ``cache["prologue"]``) run before the periodic stack.

    chunk_prefill runs one fixed-width prompt chunk at the row offset in
    ``cache["pos"]``: its KV is written at absolute positions pos..pos+S-1
    and its queries attend to the whole ring (history and chunk) under the
    slot_pos mask.  ``fill_len`` ((B,) int32) is the chunk's true token
    count: padded tail positions are clamped to pos + fill_len, so they
    collapse into one slot that stays causally masked, and "pos" advances
    by fill_len.

    lens ((B,) integer, prefill only): each row's true length where the
    prompt is padded (the engine's buckets, a static micro-batch's
    shorter rows).  The SSM layers then carry their state and conv tails
    from that length; attention layers need no lens (the padded tail's
    ring slots stay masked until decode overwrites them).

    token_groups=G (module-based batching, decode windows): B is G·ubatch,
    group-major; the MoE layers stage the G groups' routed tokens against
    one expert-span read each, and "expert_counts" gains a group axis.

    paged_blocks: a ``core.paging.PagedWeights`` in host stores that
    replaces ``params["blocks"]``: each layer's span (the whole layer, or
    its shared leaves) streams through a two-slot device buffer, and with
    expert manifests the MoE experts are fetched router-gated per layer.
    ``expert_state`` then maps each MoE group key to (pool
    (slots, ppe, page_elems), resident_map (L, E) int32) on the device:
    spans whose map entry is >= 0 are read from the pool, the rest from
    the host store.  The result gains "expert_counts" ({key: (L, E)}, or
    (L, G, E) with token_groups; tokens routed to each expert) for the
    host residency cache.

    frames ((B, encS, E), whisper): the stubbed audio frontend's output.
    A train or prefill forward runs the encoder over it, and each decoder
    layer cross-attends the result (prefill persists the layers' K and V
    in ``cache["xattn"]``, which decode reads); such a forward without
    frames raises.  patches ((B, vision_tokens, E), paligemma): the
    stubbed vision tower's output, the prefix that replaces the first
    token embeddings (``embed_tokens``); without it the model runs on
    text alone, as the engine serves it."""
    B, S = tokens.shape
    shard = policy.shard if policy is not None else None
    if shard is not None:
        TP.check_supported(cfg, shard, mode=mode, frames=frames,
                           patches=patches)
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        pos = cache["pos"]                           # (B,)
        positions = pos[:, None]
        run_mode = "decode"
    elif mode == "chunk_prefill":
        if cache is None:
            raise ValueError("chunk_prefill needs a cache")
        pos = None
        off = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if fill_len is not None:
            off = torch.minimum(off, fill_len[:, None])
        positions = cache["pos"][:, None] + off
        run_mode = "chunk"
    else:
        pos = None
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        run_mode = "full"

    enc_out = None
    if cfg.encoder_layers and mode != "decode":
        if frames is None:
            raise ValueError(f"{cfg.name}: a {mode} forward needs frames "
                             f"(B, {cfg.encoder_seq}, {cfg.d_model}) for "
                             f"its encoder")
        enc_out = encoder_forward(cfg, params, frames, policy)
    x = embed_tokens(cfg, params, tokens, positions, patches, shard)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    spans, ctx = {}, {}
    if paged_blocks is not None:
        impl = policy.impl if policy else "auto"
        spans = {k: _SpanStream(t, paged_blocks.manifests[k], x.device)
                 for k, t in paged_blocks.pages.items()}
        ctx = {k: _ExpertCtx(paged_blocks.expert_pages[k], em,
                             *(expert_state or {}).get(k, (None, None)),
                             impl=impl)
               for k, em in paged_blocks.expert_manifests.items()}
    # the prologue's layers share its first spec, as they share one stack
    stacks = [(cfg.prologue[0], params["prologue"]["p0"], "prologue", layer)
              for layer in range(len(cfg.prologue))]
    stacks += [(spec, None if spans else params["blocks"][f"p{i}"], f"p{i}",
                layer)
               for layer in range(cfg.num_periods)
               for i, spec in enumerate(cfg.period)]
    counts: Dict[str, list] = {k: [] for k in ctx}
    # remat: each block's activations are recomputed in the backward
    block = (_remat_block if policy is not None and policy.remat
             and mode == "train" else block_apply)
    for spec, p, key, layer in stacks:
        lp = (spans[key].params(layer) if p is None
              else paging.layer_slice(p, layer))
        x, aux, ec = block(
            cfg, spec, lp, x, positions=positions,
            cache=(paging.layer_slice(cache[key], layer)
                   if cache is not None else None),
            mode=run_mode, pos=pos, policy=policy,
            expert_fetch=ctx[key].make_fetch(layer) if key in ctx else None,
            token_groups=token_groups,
            lens=lens if mode == "prefill" else None, enc_out=enc_out,
            xattn_cache=(paging.layer_slice(cache["xattn"], layer)
                         if spec.cross_attn and cache is not None
                         else None), key=key)
        if p is None:
            spans[key].release(layer)
        if ec is not None:
            counts[key].append(ec)
        aux_total = aux_total + aux
    if cache is not None:
        if mode == "chunk_prefill" and fill_len is not None:
            step = fill_len.to(torch.int32)          # per-row true fill
        else:
            step = 1 if mode == "decode" else S
        cache["pos"] = cache["pos"] + step

    x = by_group(lambda x: apply_norm(cfg, params.get("final_norm", {}), x),
                 token_groups, x)
    out = {"hidden": x, "cache": cache, "aux_loss": aux_total}
    if ctx:
        out["expert_counts"] = {k: torch.stack(v) for k, v in counts.items()}
    return out


def unembed(cfg: ModelConfig, params, hidden,
            token_groups: Optional[int] = None, shard=None,
            vocab_local: bool = False):
    """hidden: (..., E) -> logits (..., V) float32 (with gemma2 softcap).
    token_groups: a window's rows, projected group by group.  Under
    ``shard`` with the vocabulary split, each rank projects onto its rows
    of the table; the columns are gathered whole unless ``vocab_local``
    (the loss's vocab-parallel cross-entropy takes them as they are)."""
    w = _table(params, shard, "tokens" if cfg.tie_embeddings else "lm_head")
    w = w.t() if cfg.tie_embeddings else w
    if shard is not None and w.shape[-1] != cfg.vocab_size:
        logits = softcap(by_group(lambda h: TP.vocab_logits(shard, h, w),
                                  token_groups, hidden), cfg.logit_softcap)
        return logits if vocab_local else TP.gather_vocab(shard, logits)
    w = w.float()
    logits = by_group(lambda h: torch.matmul(h.float(), w), token_groups,
                      hidden)
    return softcap(logits, cfg.logit_softcap)
