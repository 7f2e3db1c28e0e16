"""Plain PyTorch versions of the port's kernels: the CPU execution path and
the allclose targets the CUDA kernels are held against on the card
(``repro/kernels/ref.py`` and ``ops.flash_prefill``'s reference path)."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, chunked_attention


def moe_ffn_ref(xbuf, wi, wo, wi_scale=None, wo_scale=None, *,
                act: str = "silu"):
    """xbuf: (E,C,D); wi: (E,D,2,F); wo: (E,F,D) -> (E,C,D), computed in
    f32 and cast to xbuf's dtype.  Per-expert scales (E,) dequantize
    weight-only quantized experts."""
    wi = wi.float()
    wo = wo.float()
    if wi_scale is not None:
        wi = wi * wi_scale.float()[:, None, None, None]
    if wo_scale is not None:
        wo = wo * wo_scale.float()[:, None, None]
    h = torch.einsum("ecd,edgf->ecgf", xbuf.float(), wi)
    y = act_fn(act)(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("ecf,efd->ecd", y, wo).to(xbuf.dtype)


def gqa_decode_ref(q, k, v, valid, *, scale: float, attn_softcap: float = 0.0):
    """q: (B,H,D); k: (B,W,Hkv,D); v: (B,W,Hkv,Dv); valid: (B,W) bool.
    Returns (o_unnorm (B,H,Dv) f32, m (B,H) f32, l (B,H) f32) — the
    ``models.attention.attention_partials`` contract."""
    from repro_torch.models.attention import attention_partials
    return attention_partials(q, k, v, valid, scale=scale,
                              attn_softcap=attn_softcap)


def flash_prefill_ref(q, k, v, kv_len=None, *, causal: bool = True,
                      window: int = 0, attn_softcap: float = 0.0, scale=None):
    """q: (B,S,H,D); k/v: (B,Skv,Hkv,D/Dv); kv_len: optional (B,).
    Returns (B,S,H,Dv) — ``models.common.chunked_attention``."""
    return chunked_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap, scale=scale,
                             kv_len=kv_len)
