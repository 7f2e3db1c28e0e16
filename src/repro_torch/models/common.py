"""Shared model building blocks: norms, activations, RoPE, softcap, and the
memory-efficient (flash-style) chunked attention in plain PyTorch — the
counterpart of ``repro/models/common.py``.

Everything here is a plain function over tensors and explicit parameter
dicts.  ``chunked_attention`` is the plain version of the flash-prefill
kernel (``kernels/flash_prefill.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -0.7 * torch.finfo(torch.float32).max

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string ("bfloat16", ...)."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float, offset: float = 0.0):
    """RMSNorm; gemma-style uses (1 + w) which callers get via offset=1."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * (offset + weight.float())
    return xf.to(dt)


def layernorm(x, weight, bias, eps: float):
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        xf = xf * weight.float()
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(dt)


def apply_norm(cfg: ModelConfig, p: Optional[dict], x):
    """Dispatch on cfg.norm. `p` is the norm's param dict (may be empty)."""
    if cfg.norm == "rmsnorm":
        offset = 1.0 if cfg.scale_embeddings else 0.0  # gemma family: (1+w)
        return rmsnorm(x, p["scale"], cfg.norm_eps, offset=offset)
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.norm == "nonparametric_ln":
        return layernorm(x, None, None, cfg.norm_eps)
    raise ValueError(cfg.norm)


# ---------------------------------------------------------------------------
# Activations / softcap
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "gelu_mlp": _gelu_tanh}[name]


def softcap(x, cap: float):
    """gemma2 logit soft-capping: cap * tanh(x / cap). No-op when cap==0."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # (d/2,)
    ang = positions[..., None].float() * freqs               # (..., S, d/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Memory-efficient chunked attention (flash-style, plain PyTorch).
#
# The prefill/train attention path and the plain version of the
# flash-prefill kernel: it never materializes the full (S x S) score matrix
# — it walks KV chunks with a running (max, sumexp) pair.
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      attn_softcap: float = 0.0, scale: Optional[float] = None,
                      q_offset=0, kv_len=None, chunk: int = 1024):
    """Grouped-query chunked attention.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, Dv-compatible). Hq % Hkv == 0.
    q_offset: absolute position of q[0] for causal masking against an
      already-populated KV cache.
    kv_len: optional (B,) valid-length mask for the KV sequence.
    Returns (B, Sq, Hq, Dv) in q's dtype.
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    qf = (q.float() * scale).reshape(B, Sq, Hkv, group, D)
    q_pos = q_offset + torch.arange(Sq, device=dev)              # (Sq,)
    if kv_len is None:
        kv_len_arr = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    else:
        kv_len_arr = kv_len.to(device=dev, dtype=torch.int32)

    m = torch.full((B, Sq, Hkv, group), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Sq, Hkv, group), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, Hkv, group, Dv), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, chunk):
        kc = k[:, c0:c0 + chunk].float()
        vc = v[:, c0:c0 + chunk].float()
        kv_pos = c0 + torch.arange(kc.shape[1], device=dev)      # (chunk,)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc)
        s = softcap(s, attn_softcap)
        mask = (kv_pos[None, :] < kv_len_arr[:, None])[:, None, :]
        if causal:
            cm = kv_pos[None, :] <= q_pos[:, None]               # (Sq, chunk)
            if window:
                cm &= kv_pos[None, :] > (q_pos[:, None] - window)
            mask = mask & cm[None, :, :]
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(B, Sq, Hq, Dv).to(q.dtype)
