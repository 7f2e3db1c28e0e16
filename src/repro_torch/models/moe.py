"""Mixture-of-Experts FFN of the PyTorch port (``repro/models/moe.py``).

Execution paths (numerically equivalent up to capacity drops):

  * ``moe_dense``   — masked loop over experts; the oracle for tests.
  * ``moe_grouped`` — capacity-bucketed grouped FFN: scatter tokens to
    (E, C, D) buckets, run the grouped expert FFN (the ``moe_ffn`` kernel
    with ``use_kernel``), gather back.

Gate/up projections are stored as (D, 2, F), as in the JAX package.
Expert parallelism and the expert-paged path are later slices.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import act_fn


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def route(cfg: ModelConfig, router_w, x):
    """x: (T, D) -> (weights (T,k) f32, idx (T,k) int64, aux_loss scalar)."""
    scores = torch.matmul(x.float(), router_w.float())
    if cfg.router_scale:                       # deepseek: sigmoid + renorm
        probs = torch.sigmoid(scores)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(scores, dim=-1)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    # Switch-style load-balance loss over softmax probabilities
    sm = torch.softmax(scores, dim=-1)
    T = x.shape[0]
    frac = torch.zeros((cfg.num_experts,), dtype=torch.float32,
                       device=x.device)
    frac.index_add_(0, idx.reshape(-1),
                    torch.full((idx.numel(),), 1.0 / (T * cfg.top_k),
                               device=x.device))
    aux = cfg.num_experts * torch.sum(frac * sm.mean(0))
    return w, idx, aux


def expert_weights(p: Dict, dtype):
    """Dequantize int8 experts (weight-only quant, per-expert scale) to the
    compute dtype; pass-through otherwise."""
    wi, wo = p["wi"], p["wo"]
    if "wi_scale" in p:
        wi = wi.to(dtype) * p["wi_scale"].to(dtype)[:, None, None, None]
        wo = wo.to(dtype) * p["wo_scale"].to(dtype)[:, None, None]
    return wi, wo


def gated_ffn(cfg: ModelConfig, wi, wo, x):
    """x: (..., D); wi: (D, 2, F); wo: (F, D)."""
    h = torch.einsum("...d,dgf->...gf", x, wi.to(x.dtype))
    y = act_fn(cfg.ffn_act)(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("...f,fd->...d", y, wo.to(x.dtype))


# ---------------------------------------------------------------------------
# Capacity bucketing
# ---------------------------------------------------------------------------

def _bucket(dest, n_buckets: int, cap: int):
    """dest: (N,) in [0, n_buckets) or -1. Returns (slot (N,), keep (N,)):
    rank of each entry within its bucket; keep = slot < cap and dest >= 0."""
    onehot = dest[:, None] == torch.arange(n_buckets, device=dest.device)
    rank = torch.cumsum(onehot.long(), dim=0) - 1                # (N, nb)
    slot = torch.where(onehot, rank, 0).sum(1)
    keep = (dest >= 0) & (slot < cap)
    return slot, keep


def stage_bucket(dest, n_buckets: int, cap: int, groups: int = 1):
    """Staging map of module-based batching: ranking per (group, bucket)
    with per-group capacity ``cap``, staged slot ``g·cap + rank``.  dest is
    laid out group-major.  groups=1 is ``_bucket`` exactly."""
    N = dest.shape[0]
    if N % groups:
        raise ValueError("flat entries must split evenly over groups")
    g = torch.arange(N, device=dest.device) // (N // groups)
    gb = torch.where(dest >= 0, g * n_buckets + dest, -1)
    rank, keep = _bucket(gb, groups * n_buckets, cap)
    return g * cap + rank, keep


def grouped_ffn(cfg: ModelConfig, wi, wo, xbuf, use_kernel: bool = False,
                wi_scale=None, wo_scale=None, impl: str = "auto"):
    """xbuf: (E, C, D); wi: (E, D, 2, F); wo: (E, F, D) -> (E, C, D).
    use_kernel: the grouped expert FFN kernel (``ops.moe_ffn``, f32
    internally); otherwise plain einsums in xbuf's dtype, as the JAX path."""
    if use_kernel:
        return ops.moe_ffn(xbuf, wi, wo, wi_scale, wo_scale,
                           act=cfg.ffn_act, impl=impl)
    if wi_scale is not None:
        wi = wi.to(xbuf.dtype) * wi_scale[:, None, None, None].to(xbuf.dtype)
        wo = wo.to(xbuf.dtype) * wo_scale[:, None, None].to(xbuf.dtype)
    h = torch.einsum("ecd,edgf->ecgf", xbuf, wi.to(xbuf.dtype))
    y = act_fn(cfg.ffn_act)(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("ecf,efd->ecd", y, wo.to(xbuf.dtype))


# ---------------------------------------------------------------------------
# Dense (oracle) path
# ---------------------------------------------------------------------------

def moe_dense(cfg: ModelConfig, p: Dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D). Returns (out (T,D), aux_loss)."""
    w, idx, aux = route(cfg, p["router"], x)
    wi_all, wo_all = expert_weights(p, x.dtype)
    out = torch.zeros_like(x, dtype=torch.float32)
    for e in range(cfg.num_experts):
        y = gated_ffn(cfg, wi_all[e], wo_all[e], x)
        we = torch.where(idx == e, w, 0.0).sum(-1)                # (T,)
        out = out + y.float() * we[:, None]
    out = out.to(x.dtype)
    if cfg.num_shared_experts:
        out = out + gated_ffn(cfg, p["shared"]["wi"], p["shared"]["wo"], x)
    return out, aux


# ---------------------------------------------------------------------------
# Grouped path
# ---------------------------------------------------------------------------

def moe_grouped(cfg: ModelConfig, p: Dict, x, *, capacity_factor=None,
                use_kernel: bool = False, impl: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D).  Every shape depends on T alone (the capacity too), and
    nothing is read back to the host, so a decode step keeps fixed shapes."""
    T, D = x.shape
    NE, K = cfg.num_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    cap = max(1, int(T * K * cf / NE + 0.999))

    w, idx, aux = route(cfg, p["router"], x)
    flat_e = idx.reshape(-1)                                     # (T*K,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_w = w.reshape(-1)
    slot, keep = stage_bucket(flat_e, NE, cap)
    e_safe = torch.where(keep, flat_e, 0)
    s_safe = torch.where(keep, slot, cap - 1)

    xbuf = torch.zeros((NE, cap, D), dtype=x.dtype, device=x.device)
    xbuf.index_put_((e_safe, s_safe),
                    torch.where(keep[:, None], x[flat_t], 0).to(x.dtype),
                    accumulate=True)
    ybuf = grouped_ffn(cfg, p["wi"], p["wo"], xbuf, use_kernel,
                       p.get("wi_scale"), p.get("wo_scale"), impl=impl)
    y = ybuf[e_safe, s_safe]                                     # (T*K, D)
    y = torch.where(keep[:, None], y, 0) * flat_w[:, None].to(x.dtype)
    out = torch.zeros_like(x).index_add_(0, flat_t, y)
    if cfg.num_shared_experts:
        out = out + gated_ffn(cfg, p["shared"]["wi"], p["shared"]["wo"], x)
    return out, aux


def moe_apply(cfg: ModelConfig, p: Dict, x3, policy=None):
    """Dispatch on the execution policy. x3: (B, S, D)."""
    B, S, D = x3.shape
    x = x3.reshape(B * S, D)
    if policy is not None and policy.moe_impl == "grouped":
        out, aux = moe_grouped(cfg, p, x, use_kernel=policy.use_kernels,
                               impl=policy.impl)
    else:
        out, aux = moe_dense(cfg, p, x)
    return out.reshape(B, S, D), aux
