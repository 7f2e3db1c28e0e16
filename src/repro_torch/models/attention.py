"""Attention blocks of the PyTorch port (``repro/models/attention.py``): GQA
and DeepSeek-style MLA, in the ``full`` (train / prefill with an optional
ring write), ``decode`` and ``chunk`` (chunked-prefill admission) modes.

Decode attention is expressed through partials (unnormalized output,
running max, running denominator), the contract of the flash-decode kernels.
GQA decode over the dense ring runs the flash-decode kernel where the JAX
reference runs the plain ``attention_partials``; decode over the block-paged
arena runs the paged flash-decode kernels (GQA and absorbed MLA) in their
fused decode-write form, as the reference does; and full-mode prefill runs
the flash-prefill kernel where the reference runs ``chunked_attention``;
``impl="ref"`` runs those plain versions instead (``kernels/ops.py``).
whisper's cross-attention (``kv_override``) runs the flash-prefill kernel
in its non-causal form, S queries over the encoder's keys, in prefill and
in decode alike.
Chunk mode attends a prompt chunk's queries against the whole ring in
plain PyTorch and f32, as the reference computes it outside any kernel.
Under a sharding plan, GQA decode over the dense ring runs the plan's
sequence-sharded attention (``attn_fn``: the same kernel's partials on each
rank's slice of the ring, combined across the ranks) after the ring write.
A plan over more than one rank (``shard``) runs this rank's query heads
(``_gqa_tp``): prefill and training through ``flash_prefill`` on them, and
decode writes the new token into the ring's slot only on the rank that
holds it, attends every head over each rank's slots and keeps its own
heads for ``wo``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_MLA, ATTN_WINDOW, LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kvcache
from repro_torch.models.common import NEG_INF, apply_rope, rmsnorm, softcap


def attention_partials(q, k, v, valid, *, scale: float,
                       attn_softcap: float = 0.0, k_scale=None, v_scale=None):
    """q: (B,H,D), k/v: (B,W,Hkv,Dv), valid: (B,W) bool.
    Returns (o_unnorm (B,H,Dv) f32, m (B,H) f32, l (B,H) f32).

    int8 KV passes its per-(token, head) ``k_scale``/``v_scale`` planes
    ((B,W,Hkv) f32) and the dequant folds into the contractions —
    ``s = (q · k_int) · k_scale`` and ``o = (p · v_scale) @ v_int`` — as
    the kernels fold them into their tiles."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bwhd->bhgw", qf, k.float())
    if k_scale is not None:
        s = s * torch.swapaxes(k_scale, 1, 2)[:, :, None, :]
    s = softcap(s, attn_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    # guard: a row may hold zero valid slots
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None]) * (s > NEG_INF / 2)
    l = p.sum(-1)
    if v_scale is not None:
        p = p * torch.swapaxes(v_scale, 1, 2)[:, :, None, :]
    o = torch.einsum("bhgw,bwhd->bhgd", p, v.float())
    Dv = v.shape[-1]
    return o.reshape(B, H, Dv), m_safe.reshape(B, H), l.reshape(B, H)


def combine_partials(o, m, l):
    """Normalize partials (single shard)."""
    return o / torch.clamp(l[..., None], min=1e-30)


def decode_valid_mask(slot_pos, pos, window: int):
    """slot_pos: (B,W) absolute positions in ring slots; pos: (B,) current
    query position.  Valid = written & causal (& within window)."""
    v = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        v &= slot_pos > (pos[:, None] - window)
    return v


def chunk_valid_mask(slot_pos, q_positions, window: int):
    """Multi-query variant for chunked prefill: q_positions (B,S) absolute
    query positions; returns (B,S,W).  The chunk's own KV is written into
    the ring before attention, so intra-chunk causality falls out of the
    same slot_pos <= q_pos test as the history's."""
    sp = slot_pos[:, None, :]
    v = (sp >= 0) & (sp <= q_positions[:, :, None])
    if window:
        v &= sp > (q_positions[:, :, None] - window)
    return v


def chunk_attention_ring(q, k, v, valid, *, scale: float,
                         attn_softcap: float = 0.0, k_scale=None,
                         v_scale=None):
    """Chunked-prefill attention: S chunk queries against the full ring.
    q: (B,S,H,D); k/v: (B,W,Hkv,Dv); valid: (B,S,W) bool.  Returns
    (B,S,H,Dv) f32 — the multi-query form of attention_partials +
    combine_partials.  An int8 ring passes ``k_scale``/``v_scale``
    ((B,W,Hkv) f32), folded into the score and value contractions as in
    ``attention_partials``: no dequantized ring is built."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf = (q.float() * scale).reshape(B, S, Hkv, g, D)
    s = torch.einsum("bshgd,bwhd->bshgw", qf, k.float())
    if k_scale is not None:
        s = s * torch.swapaxes(k_scale, 1, 2)[:, None, :, None, :]
    s = softcap(s, attn_softcap)
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None]) * (s > NEG_INF / 2)
    l = p.sum(-1)
    if v_scale is not None:
        p = p * torch.swapaxes(v_scale, 1, 2)[:, None, :, None, :]
    o = torch.einsum("bshgw,bwhd->bshgd", p, v.float())
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(B, S, H, v.shape[-1])


def _check_sharded_ring(cache, quantized: bool) -> None:
    """What a sharded attention takes here: a dense ring in the model
    dtype.  No test drives the others."""
    if kvcache.is_paged(cache):
        raise NotImplementedError("a block-paged cache under a sequence-"
                                  "sharded attention is not ported")
    if quantized:
        raise NotImplementedError("int8 KV under a sequence-sharded "
                                  "attention is not ported")


def _proj(x, w, b=None):
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _local_heads(H: int, Hkv: int, index: int, Dh: int,
                 cols: int) -> Tuple[int, int, bool]:
    """(this rank's first query head, how many, whether split) from the
    columns of its ``wq`` slice; a split within a head is not ported."""
    if cols % Dh:
        raise NotImplementedError(f"wq split into {cols} columns, within a "
                                  f"head of {Dh}, is not ported")
    Hl = cols // Dh
    G = H // Hkv
    if Hl < H and (Hl % G if Hl >= G else G % Hl):
        raise NotImplementedError(f"{Hl} query heads a rank in groups of "
                                  f"{G} are not ported")
    return (index * Hl if Hl < H else 0), Hl, Hl < H


def _gqa_tp(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, positions, *,
            cache, mode, pos, causal, impl, attn_fn, sh):
    """``gqa_forward`` on this rank's query heads (a plan over more than one
    rank).  ``wq`` / ``bq`` hold this rank's heads and ``wo`` their rows;
    ``wk`` / ``wv`` (and biases) its KV heads, or the whole leaf, or a
    slice finer than a head, which is gathered whole (FSDP's pair, so its
    gradient is summed over the ranks and cut back)."""
    from repro_torch.distributed import collectives as C
    B, S, E = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale or Dh ** -0.5
    window = cfg.window_size if spec.attn == ATTN_WINDOW else 0
    if cache is not None:
        _check_sharded_ring(cache, cfg.kv_dtype == "int8")
    if mode not in ("full", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} under a plan "
                                  f"over more than one rank is not ported")
    group = sh.group_of("heads")
    h0, Hl, split = _local_heads(H, Hkv, sh.index_of("heads"), Dh,
                                 p["wq"].shape[-1])
    kv_group = sh.group_of("kv_heads")
    xin = C.copy_to(x, group) if split else x
    q = _proj(xin, p["wq"], p.get("bq")).reshape(B, S, Hl, Dh)

    def kv(wn, bn):
        """(its heads (B,S,h,Dh), the first of them)."""
        w, b = p[wn], p.get(bn)
        cols = w.shape[-1]
        if cols == Hkv * Dh:
            if split:
                w = C.copy_to(w, group)
                b = None if b is None else C.copy_to(b, group)
        elif cols % Dh or Hl == H or (Hkv // (cols // Dh)) != H // Hl:
            w = C.fsdp_gather(w, kv_group, w.dim() - 1)
            b = None if b is None else C.fsdp_gather(b, kv_group, 0)
        else:                                  # this rank's KV heads
            return (_proj(xin, w, b).reshape(B, S, cols // Dh, Dh),
                    sh.index_of("kv_heads") * (cols // Dh))
        return _proj(xin, w, b).reshape(B, S, Hkv, Dh), 0

    (k, k0), (v, _) = kv("wk", "bk"), kv("wv", "bv")
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    def whole(t):           # every KV head, for the ring
        return t if t.shape[2] == Hkv else C.gather_from(t.contiguous(),
                                                         kv_group, 2)

    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("decode attends one token per row over a cache")
        qa = C.gather_from(q.contiguous(), group, 2) if split else q
        kvcache.write_decode(cache, {"k": whole(k), "v": whole(v)}, pos,
                             ring=sh.ring(cache["slot_pos"].shape[-1]))
        valid = decode_valid_mask(cache["slot_pos"], pos, window)
        if attn_fn is not None:
            o = attn_fn(qa[:, 0], cache["k"], cache["v"], valid, scale=scale,
                        attn_softcap=cfg.attn_softcap, impl=impl)
        else:
            o = combine_partials(*ops.gqa_decode(
                qa[:, 0], cache["k"], cache["v"], valid, scale=scale,
                attn_softcap=cfg.attn_softcap, impl=impl))
        o = o[:, None, h0:h0 + Hl].to(x.dtype)               # (B,1,Hl,Dh)
    else:
        G = H // Hkv
        lo = h0 // G - k0
        n = max(1, Hl // G)
        o = ops.flash_prefill(q, k[:, :, lo:lo + n].contiguous(),
                              v[:, :, lo:lo + n].contiguous(), causal=causal,
                              window=window, attn_softcap=cfg.attn_softcap,
                              scale=scale, impl=impl)
        if cache is not None:    # prefill: persist this rank's ring slots
            seq_pos = (positions if positions.ndim == 1
                       else positions[0]).to(torch.int32)
            kvcache.write_prefill(cache, {"k": whole(k), "v": whole(v)},
                                  seq_pos,
                                  ring=sh.ring(cache["slot_pos"].shape[-1]))
    out = _proj(o.reshape(B, S, Hl * Dh), p["wo"])
    return (C.reduce_from(out, group) if split else out), cache


def gqa_forward(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, positions, *,
                cache: Optional[Dict], mode: str, pos=None,
                causal: bool = True, kv_override: Optional[Tuple] = None,
                impl: str = "auto", attn_fn=None, shard=None):
    """x: (B,S,E).  mode: 'full' (train / prefill, writing the ring when a
    cache is given), 'decode' (S == 1: write the ring, then attend over
    it) or 'chunk' (write a prompt chunk at its absolute positions, then
    attend its queries over the whole ring).  Returns (out, layer_cache);
    the cache is updated in place.

    kv_override: (k, v) already built, (B,Skv,Hkv,Dh) each (whisper's
    cross-attention over the encoder's positions): only the query is
    projected, and the S queries attend to all Skv keys, non-causal and
    without a window, in 'full' mode (also for one decode query).

    attn_fn: a sharding plan's sequence-sharded decode attention
    (``distributed.collectives.make_seq_sharded_attn``), which takes the
    place of the dense ring's partials after the ring write.

    shard: a plan over more than one rank (``_gqa_tp``)."""
    if shard is not None:
        return _gqa_tp(cfg, spec, p, x, positions, cache=cache, mode=mode,
                       pos=pos, causal=causal, impl=impl, attn_fn=attn_fn,
                       sh=shard)
    B, S, E = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale or Dh ** -0.5
    window = cfg.window_size if spec.attn == ATTN_WINDOW else 0

    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, Dh)
    if kv_override is None:
        k = _proj(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, Dh)
        v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, Dh)
        if cfg.pos == "rope":
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        if mode != "full" or cache is not None:
            raise ValueError("cross-attention runs in full mode, no cache")
        k, v = kv_override
        causal, window = False, 0
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)

    # int8 KV: the ring holds the quantized k, v and their scales; the
    # kernels and the chunk attention fold the scales into their tiles
    quantized = cfg.kv_dtype == "int8"
    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("decode attends one token per row over a cache")
        new = kvcache.quantize_kv(k, v) if quantized else {"k": k, "v": v}
        if attn_fn is not None:
            _check_sharded_ring(cache, quantized)
            kvcache.write_decode(cache, new, pos)
            valid = decode_valid_mask(cache["slot_pos"], pos, window)
            o = attn_fn(q[:, 0], cache["k"], cache["v"], valid, scale=scale,
                        attn_softcap=cfg.attn_softcap, impl=impl)
            part = None
        elif kvcache.is_paged(cache):
            # block-paged pool: fused decode-write straight through the
            # page table (the kernel merges the fresh token into its
            # block, then the arena scatter runs)
            part = ops.paged_gqa_decode_fused(
                q[:, 0], cache, new, pos, scale=scale,
                attn_softcap=cfg.attn_softcap, window=window, impl=impl)
        else:
            kvcache.write_decode(cache, new, pos)
            valid = decode_valid_mask(cache["slot_pos"], pos, window)
            part = ops.gqa_decode(q[:, 0], cache["k"], cache["v"], valid,
                                  scale=scale, attn_softcap=cfg.attn_softcap,
                                  k_scale=cache.get("k_scale"),
                                  v_scale=cache.get("v_scale"), impl=impl)
        if part is not None:
            o = combine_partials(*part)
        o = o[:, None].to(x.dtype)                           # (B,1,H,Dh)
    elif mode == "full":
        # full-sequence forward always begins at absolute position 0
        o = ops.flash_prefill(q, k, v, causal=causal, window=window,
                              attn_softcap=cfg.attn_softcap, scale=scale,
                              impl=impl)
        if cache is not None:    # prefill: persist KV into the ring
            seq_pos = (positions if positions.ndim == 1
                       else positions[0]).to(torch.int32)
            new = kvcache.quantize_kv(k, v) if quantized else {"k": k,
                                                               "v": v}
            kvcache.write_prefill(cache, new, seq_pos)
    elif mode == "chunk":
        # chunked prefill at a row offset: write the chunk's KV into the
        # ring at its absolute positions, then attend its queries over the
        # whole ring.  Prefill runs on a dense batch-1 scratch; the paged
        # pool is written by the slot inserts, never by prefill
        if cache is None or kvcache.is_paged(cache):
            raise ValueError("chunk mode runs on a dense ring")
        new = kvcache.quantize_kv(k, v) if quantized else {"k": k, "v": v}
        kvcache.write_prefill(cache, new, positions[0].to(torch.int32))
        valid = chunk_valid_mask(cache["slot_pos"], positions, window)
        o = chunk_attention_ring(q, cache["k"], cache["v"], valid,
                                 scale=scale, attn_softcap=cfg.attn_softcap,
                                 k_scale=cache.get("k_scale"),
                                 v_scale=cache.get("v_scale")).to(x.dtype)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")
    out = _proj(o.reshape(B, S, H * Dh), p["wo"])
    return out, cache


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V3).
#
# Prefill uses the naive (decompressed) form; decode uses the absorbed form
# — W_uk folded into the query and W_uv applied after attention over the
# latent cache — so the per-token cache is kv_lora + rope values and decode
# attends over the compressed latents.
# ---------------------------------------------------------------------------

def mla_forward(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, positions, *,
                cache: Optional[Dict], mode: str, pos=None,
                causal: bool = True, impl: str = "auto", attn_fn=None):
    """x: (B,S,E); modes as `gqa_forward`.  Returns (out, layer_cache).
    A sequence-sharded decode (``attn_fn``) is not ported for MLA: no test
    drives it, and ``gqa_decode`` cannot take the absorbed heads (128
    query heads over one latent head of 576).  A plan over more than one
    rank refuses MLA before any layer (``tensor_parallel.
    check_supported``)."""
    if attn_fn is not None and mode == "decode":
        raise NotImplementedError("MLA decode under a sequence-sharded "
                                  "attention is not ported")
    B, S, E = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    lat = cfg.kv_lora_rank
    scale = (dn + dr) ** -0.5

    cq = rmsnorm(_proj(x, p["wdq"]), p["q_norm"], cfg.norm_eps)
    q = _proj(cq, p["wuq"]).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    ckv = rmsnorm(_proj(x, p["wdkv"]), p["kv_norm"], cfg.norm_eps)  # (B,S,r)
    kr = _proj(x, p["wkr"]).reshape(B, S, 1, dr)
    kr = apply_rope(kr, positions, cfg.rope_theta)[:, :, 0]         # (B,S,dr)
    wuk = p["wuk"].reshape(lat, H, dn)
    wuv = p["wuv"].reshape(lat, H, dv)

    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("decode attends one token per row over a cache")
        # absorbed queries: q_lat (B,H,r) = q_nope @ W_uk^T, in f32; the
        # rope half joins along the latent axis, so that the score is
        # q_lat . ckv + q_rope . kr, and qcat is cast to the activations'
        # dtype as in the reference
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                             wuk.float())
        qcat = torch.cat([q_lat, q_rope[:, 0].float()], -1).to(x.dtype)
        new = {"ckv": ckv, "kr": kr}
        if kvcache.is_paged(cache):
            # the paged latent arena: fused decode-write through the page
            # table (the kernel merges the fresh latent into its block,
            # then the arena scatter runs)
            part = ops.paged_mla_decode_fused(qcat, cache, new, pos,
                                              scale=scale, impl=impl)
        else:
            # the dense latent rings of the prologue layers: the plain
            # partials, as in the reference.  The dense flash-decode
            # kernel does not take this shape: its group of G = 128 query
            # heads against one latent head of D = 576 would need
            # 128 * (576 + 64) * 4 bytes = 327 KB of shared memory per
            # block, above the 227 KB a Hopper block may have
            kvcache.write_decode(cache, new, pos)
            valid = decode_valid_mask(cache["slot_pos"], pos, 0)
            kcat = torch.cat([cache["ckv"], cache["kr"]], -1)[:, :, None, :]
            part = attention_partials(qcat, kcat.to(x.dtype),
                                      cache["ckv"][:, :, None, :], valid,
                                      scale=scale)
        o_lat = combine_partials(*part)                      # (B,H,r) f32
        # decompress with W_uv, in f32
        o = torch.einsum("bhr,rhd->bhd", o_lat, wuv.float())
        o = o[:, None].to(x.dtype)                           # (B,1,H,dv)
    elif mode == "full":
        k_nope = torch.einsum("bsr,rhd->bshd", ckv, wuk.to(ckv.dtype))
        v = torch.einsum("bsr,rhd->bshd", ckv, wuv.to(ckv.dtype))
        k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], -1)
        qfull = torch.cat([q_nope, q_rope], -1)
        o = ops.flash_prefill(qfull, k, v.contiguous(), causal=causal,
                              scale=scale, impl=impl)
        if cache is not None:    # prefill: persist the latents into the ring
            seq_pos = (positions if positions.ndim == 1
                       else positions[0]).to(torch.int32)
            kvcache.write_prefill(cache, {"ckv": ckv, "kr": kr}, seq_pos)
    elif mode == "chunk":
        # chunked prefill: persist the chunk's latents at their absolute
        # positions, then the naive (decompressed) form over the ring
        if cache is None or kvcache.is_paged(cache):
            raise ValueError("chunk mode runs on a dense ring")
        kvcache.write_prefill(cache, {"ckv": ckv, "kr": kr},
                              positions[0].to(torch.int32))
        ckv_r = cache["ckv"].float()                            # (B,W,r)
        k_nope_r = torch.einsum("bwr,rhd->bwhd", ckv_r, wuk.float())
        v_r = torch.einsum("bwr,rhd->bwhd", ckv_r, wuv.float())
        W = ckv_r.shape[1]
        kr_r = cache["kr"][:, :, None, :].expand(B, W, H, dr).float()
        k_r = torch.cat([k_nope_r, kr_r], -1)
        qfull = torch.cat([q_nope, q_rope], -1)
        valid = chunk_valid_mask(cache["slot_pos"], positions, 0)
        o = chunk_attention_ring(qfull, k_r, v_r, valid,
                                 scale=scale).to(x.dtype)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")
    out = _proj(o.reshape(B, S, H * dv), p["wo"])
    return out, cache


def attn_forward(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, positions,
                 shard=None, **kw):
    if spec.attn == ATTN_MLA:
        return mla_forward(cfg, spec, p, x, positions, **kw)
    return gqa_forward(cfg, spec, p, x, positions, shard=shard, **kw)
