"""Causal flash attention for prefill: the wrapper of
``csrc/flash_prefill.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill.py::
flash_prefill``.  On the H100 it is bound by operations (about
4·B·H·S²·D/2 for a causal prompt); see the source for the design.  A CPU
tensor takes the plain version (``ref.flash_prefill_ref``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def flash_prefill(q, k, v, kv_len=None, *, causal: bool = True,
                  window: int = 0, attn_softcap: float = 0.0, scale=None):
    """q: (B,S,H,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv); kv_len: optional
    (B,) valid key counts.  Returns the normalized (B,S,H,Dv) in q's dtype;
    a query row with no valid key gives 0."""
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, kv_len, causal=causal,
                                     window=window, attn_softcap=attn_softcap,
                                     scale=scale)
    B, S, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"flash_prefill kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if k.shape != (B, Skv, Hkv, D) or H % Hkv:
        raise ValueError(f"flash_prefill shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    build.require_operands("flash_prefill", q.dtype, q.device, q=q, k=k, v=v)
    if kv_len is None:
        kv_len = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    elif kv_len.shape != (B,) or kv_len.device != q.device:
        raise ValueError(f"flash_prefill: kv_len must be (B,) on {q.device}")
    kv_len = kv_len.to(torch.int32).contiguous()
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    if B * S * H == 0:
        return o
    fn = build.function("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = fn(build.DTYPE_CODES[q.dtype], build.ptr(q), build.ptr(k),
             build.ptr(v), build.ptr(kv_len), build.ptr(o), B, S, Skv, H,
             Hkv, D, Dv, int(causal), int(window), float(scale),
             float(attn_softcap), build.stream(q.device))
    build.check("flash_prefill", err)
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0
