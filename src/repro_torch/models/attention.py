"""GQA attention of the PyTorch port (``repro/models/attention.py``), in the
``full`` (train / prefill with an optional ring write) and ``decode`` modes.

Decode attention is expressed through partials (unnormalized output,
running max, running denominator), the contract of the flash-decode kernel.
Decode runs the flash-decode kernel where the JAX reference runs the plain
``attention_partials``, and full-mode prefill runs the flash-prefill kernel
where the reference runs ``chunked_attention``; ``impl="ref"`` runs those
plain versions instead (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ATTN_MLA, ATTN_WINDOW, LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import kvcache
from repro_torch.models.common import NEG_INF, apply_rope, softcap


def attention_partials(q, k, v, valid, *, scale: float,
                       attn_softcap: float = 0.0):
    """q: (B,H,D), k/v: (B,W,Hkv,Dv), valid: (B,W) bool.
    Returns (o_unnorm (B,H,Dv) f32, m (B,H) f32, l (B,H) f32)."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, g, D)
    s = torch.einsum("bhgd,bwhd->bhgw", qf, k.float())
    s = softcap(s, attn_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    # guard: a row may hold zero valid slots
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe[..., None]) * (s > NEG_INF / 2)
    l = p.sum(-1)
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


def _proj(x, w, b=None):
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def gqa_forward(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, positions, *,
                cache: Optional[Dict], mode: str, pos=None,
                causal: bool = True, impl: str = "auto"):
    """x: (B,S,E).  mode: 'full' (train / prefill, writing the ring when a
    cache is given) or 'decode' (S == 1: write the ring, then attend over
    it).  Returns (out, layer_cache); the cache is updated in place."""
    if spec.attn == ATTN_MLA:
        raise NotImplementedError("MLA attention is not ported yet")
    B, S, E = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale or Dh ** -0.5
    window = cfg.window_size if spec.attn == ATTN_WINDOW else 0

    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, Dh)
    k = _proj(x, p["wk"], p.get("bk")).reshape(B, S, Hkv, Dh)
    v = _proj(x, p["wv"], p.get("bv")).reshape(B, S, Hkv, Dh)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("decode attends one token per row over a cache")
        kvcache.write_decode(cache, {"k": k, "v": v}, pos)
        valid = decode_valid_mask(cache["slot_pos"], pos, window)
        part = ops.gqa_decode(q[:, 0], cache["k"], cache["v"], valid,
                              scale=scale, attn_softcap=cfg.attn_softcap,
                              impl=impl)
        o = combine_partials(*part)[:, None].to(x.dtype)     # (B,1,H,Dh)
    elif mode == "full":
        # full-sequence forward always begins at absolute position 0
        o = ops.flash_prefill(q, k, v, causal=causal, window=window,
                              attn_softcap=cfg.attn_softcap, scale=scale,
                              impl=impl)
        if cache is not None:    # prefill: persist KV into the ring
            seq_pos = (positions if positions.ndim == 1
                       else positions[0]).to(torch.int32)
            kvcache.write_prefill(cache, {"k": k, "v": v}, seq_pos)
    else:
        raise ValueError(f"attention mode {mode!r} is not ported")
    out = _proj(o.reshape(B, S, H * Dh), p["wo"])
    return out, cache
