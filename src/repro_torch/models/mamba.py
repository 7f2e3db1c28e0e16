"""Mamba-2 mixer of the PyTorch port (``repro/models/mamba.py``): the SSD
(state-space duality) chunked algorithm (arXiv:2405.21060) and an O(1)-state
decode step.

Layout (single group, G=1):
  in_proj(x) -> [z (d_in), xBC (d_in + 2N), dt (nh)]
  causal depthwise conv over xBC (width cw), SiLU
  split xBC -> x (d_in), B (N), C (N);  heads: x -> (nh, hd)
  dt = softplus(dt + dt_bias); A = -exp(a_log)  (per head)
  SSD recurrence per head h:
      S_t = exp(dt_t A_h) S_{t-1} + dt_t * B_t x_t^T        (hd x N)
      y_t = C_t . S_t + D_h x_t
  gated RMSNorm(y * silu(z)), out_proj.

``ssd_chunked`` scans fixed-size chunks: the intra-chunk work is a masked
(L x L) product per head, as batched matmuls over (row, head), and the
inter-chunk state is a sequential scan.  ``ssd_recurrent_ref`` is the
step-by-step oracle of the tests.  The mixer has no hand-written kernel:
the JAX package computes it in plain ``jnp`` too.

Two differences from the JAX package, both about the serving cache:

  * Prefill takes each row's true length ``lens``.  The engine prefills a
    prompt padded to its bucket (and a static micro-batch to its longest
    row); ``dt`` is set to 0 at positions ``>= lens[b]``, so that
    ``exp(dt A) = 1`` and the update ``dt B x^T = 0`` there, and the state
    leaves the padded tail as it was at ``lens[b]``; the conv tails are the
    ``cw-1`` inputs before ``lens[b]``.  The JAX mixer takes them at the
    padded end, so its decode continues from a state that absorbed the
    padding.
  * Prefill and decode write the layer cache in place: the engine's
    windows hand the model views of its slot pool.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import rmsnorm


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_recurrent_ref(x, dt, A, B, C, state0=None):
    """Oracle. x: (b,S,nh,hd); dt: (b,S,nh); A: (nh,); B,C: (b,S,N).
    Returns (y (b,S,nh,hd), state (b,nh,hd,N))."""
    b, S, nh, hd = x.shape
    N = B.shape[-1]
    s = (torch.zeros((b, nh, hd, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    ys = []
    for t in range(S):
        y, s = ssd_step(x[:, t].float(), dt[:, t], A, B[:, t], C[:, t], s)
        ys.append(y)
    return torch.stack(ys, 1).to(x.dtype), s


def ssd_chunked(x, dt, A, B, C, state0=None, chunk: int = 256):
    """Chunked SSD.  Same signature and semantics as ``ssd_recurrent_ref``.
    Each chunk is three batched matmuls over (row, head): the masked
    intra-chunk product, the read of the carried state, and the state
    update; the (b, nh, L, L) decay exists once a chunk."""
    b, S, nh, hd = x.shape
    N = B.shape[-1]
    L = chunk
    nchunks = -(-S // L)
    pad = nchunks * L - S
    # head-major, f32: x (b,nh,S,hd), dt (b,nh,S)
    xf = x.float().transpose(1, 2)
    dtf = dt.float().transpose(1, 2)
    Bf, Cf = B.float(), C.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        dtf = F.pad(dtf, (0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    Af = A.float()[None, :, None]                          # (1,nh,1)
    s = (torch.zeros((b, nh, hd, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    idx = torch.arange(L, device=x.device)
    causal = idx[:, None] >= idx[None, :]                  # (L,L)
    ys = []
    for c in range(nchunks):
        sl = slice(c * L, (c + 1) * L)
        xi, dti = xf[:, :, sl], dtf[:, :, sl]              # (b,nh,L,hd|)
        Bi, Ci = Bf[:, None, sl], Cf[:, None, sl]          # (b,1,L,N)
        cumA = torch.cumsum(dti * Af, dim=-1)              # (b,nh,L)
        # intra-chunk: y[i] += sum_{j<=i} (C_i.B_j) exp(cumA_i - cumA_j)
        #                                  dt_j x_j
        seg = (cumA[..., :, None] - cumA[..., None, :]).masked_fill(
            ~causal, float("-inf"))
        M = torch.matmul(Ci, Bi.transpose(-1, -2)) * torch.exp(seg)
        y = torch.matmul(M, dti[..., None] * xi)           # (b,nh,L,hd)
        # inter-chunk: y[i] += exp(cumA_i) C_i . S_prev
        y = y + torch.exp(cumA)[..., None] * torch.matmul(
            Ci, s.transpose(-1, -2))
        # S = exp(sumA) S_prev + sum_j exp(sumA - cumA_j) dt_j x_j B_j^T
        sumA = cumA[..., -1:]                              # (b,nh,1)
        w = torch.exp(sumA - cumA) * dti                   # (b,nh,L)
        s = (s * torch.exp(sumA)[..., None]
             + torch.matmul((w[..., None] * xi).transpose(-1, -2), Bi))
        ys.append(y)
    y = torch.cat(ys, 2)[:, :, :S].transpose(1, 2)         # (b,S,nh,hd)
    return y.to(x.dtype), s


def ssd_step(xt, dtt, A, Bt, Ct, state):
    """Single decode step. xt: (b,nh,hd); dtt: (b,nh); Bt/Ct: (b,N);
    state: (b,nh,hd,N). Returns (y (b,nh,hd), new_state)."""
    dtf = dtt.float()
    decay = torch.exp(dtf * A.float())                     # (b,nh)
    upd = (dtf[..., None, None] * xt.float()[..., None]
           * Bt.float()[:, None, None, :])                 # (b,nh,hd,N)
    state = state * decay[..., None, None] + upd
    y = torch.matmul(state, Ct.float()[:, None, :, None])[..., 0]
    return y.to(xt.dtype), state


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x, w, b):
    """x: (B,S,C); w: (cw,C); depthwise causal, in f32 (as the JAX
    package computes it), left-padded by cw-1."""
    cw, C = w.shape
    out = F.conv1d(F.pad(x.float().transpose(1, 2), (cw - 1, 0)),
                   w.float().t()[:, None, :], groups=C)    # (B,C,S)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


def conv_step(x_new, conv_cache, w, b):
    """x_new: (B,C); conv_cache: (B,cw-1,C). Returns (y (B,C), new_cache)."""
    window = torch.cat([conv_cache.to(x_new.dtype), x_new[:, None, :]], 1)
    y = (window.float() * w.float()).sum(1) + b.float()
    return y.to(x_new.dtype), window[:, 1:]


def _tails(v, lens, width: int):
    """The `width` rows of v (B,S,C) before each row's lens[b], zero where
    that reaches before position 0."""
    Bsz, S, _ = v.shape
    idx = lens.long()[:, None] - width + torch.arange(width,
                                                      device=v.device)
    t = torch.gather(v, 1, idx.clamp(0, S - 1)[..., None].expand(
        -1, -1, v.shape[-1]))
    return torch.where((idx >= 0)[..., None], t, torch.zeros_like(t))


# ---------------------------------------------------------------------------
# Full mixer
# ---------------------------------------------------------------------------

def mamba_forward(cfg: ModelConfig, p: Dict, x, *, cache: Optional[Dict],
                  mode: str, lens=None):
    """x: (B,S,E).  Returns out (B,S,E).  mode: "full" (train, or prefill
    when a cache is given) | "decode".  A given layer cache is written in
    place.  ``lens`` ((B,) integer, prefill only): each row's true length;
    positions at and past it leave the state and the conv tails as they
    were there (None: every row is S long)."""
    Bsz, S, E = x.shape
    d_in, nh, hd, N = _dims(cfg)
    dt_ = x.dtype

    def proj(name):
        return torch.matmul(x, p[name].to(dt_))

    z, xr, Br, Cr = proj("wz"), proj("wx"), proj("wB"), proj("wC")
    dt = F.softplus(proj("wdt").float() + p["dt_bias"].float())  # (B,S,nh)
    A = -torch.exp(p["a_log"].float())                           # (nh,)

    def silu(v):
        return F.silu(v.float()).to(dt_)

    if mode == "chunk":
        # chunked prefill would need the conv tails and the SSM state
        # carried across chunks; the engine gates overlapped admission to
        # attention-only configs, so reaching here is a bug
        raise NotImplementedError(
            "chunked prefill is not supported for SSM layers")
    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("SSM decode takes one token and a cache")
        xs, new_cx = conv_step(xr[:, 0], cache["conv_x"], p["conv_x"],
                               p["conv_bx"])
        Bp, new_cB = conv_step(Br[:, 0], cache["conv_B"], p["conv_B"],
                               p["conv_bB"])
        Cp, new_cC = conv_step(Cr[:, 0], cache["conv_C"], p["conv_C"],
                               p["conv_bC"])
        xs, Bp, Cp = silu(xs), silu(Bp), silu(Cp)
        xh = xs.reshape(Bsz, nh, hd)
        y, new_state = ssd_step(xh, dt[:, 0], A, Bp, Cp, cache["state"])
        y = y.to(dt_) + p["d_skip"].to(dt_)[None, :, None] * xh
        y = y.reshape(Bsz, 1, d_in)
        for name, val in (("conv_x", new_cx), ("conv_B", new_cB),
                          ("conv_C", new_cC), ("state", new_state)):
            cache[name].copy_(val)
    else:
        xs = silu(causal_conv(xr, p["conv_x"], p["conv_bx"]))
        Bp = silu(causal_conv(Br, p["conv_B"], p["conv_bB"]))
        Cp = silu(causal_conv(Cr, p["conv_C"], p["conv_bC"]))
        xh = xs.reshape(Bsz, S, nh, hd)
        if lens is not None:
            # past a row's true length the state stands still
            live = torch.arange(S, device=x.device)[None] < lens[:, None]
            dt = dt * live[..., None]
        y, state = ssd_chunked(
            xh, dt, A, Bp, Cp,
            state0=cache["state"] if cache is not None else None,
            chunk=cfg.ssm_chunk)
        y = y + p["d_skip"].to(dt_)[None, None, :, None] * xh
        y = y.reshape(Bsz, S, d_in)
        if cache is not None:   # prefill: persist state + conv tails
            n = (lens if lens is not None else
                 torch.full((Bsz,), S, dtype=torch.int64, device=x.device))
            cw = cfg.ssm_conv_width - 1
            for name, v in (("conv_x", xr), ("conv_B", Br),
                            ("conv_C", Cr)):
                cache[name].copy_(_tails(v, n, cw))
            cache["state"].copy_(state)

    # gated RMSNorm + out proj
    y = y.to(dt_) * F.silu(z.float()).to(dt_)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(y.dtype)).to(dt_)
