"""Flash attention for prefill, causal or not: the wrapper of
``csrc/flash_prefill.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill.py::
flash_prefill``.  On the H100 it is bound by operations (about
4·B·H·S²·D/2 for a causal prompt, 4·B·H·S·Skv·D non-causal, as whisper's
encoder and cross-attention run it) where S is long; one decode query
over whisper's encoder keys is bound by their bytes.  See the source for
the design.  bf16 takes the tensor-core body (D and Dv multiples of 8 up
to 256, its wide form, Q reloaded from shared memory, where D > 192 or
Dv > 128; the wrapper raises on others), float32 the CUDA-core body.  A
CPU tensor takes the plain version (``ref.flash_prefill_ref``); a CUDA
tensor launches the kernel or raises.

Training differentiates through ``FlashPrefillFn``: its forward launches
the kernel with each row's log-sum-exp, and its backward launches
``csrc/flash_prefill_bwd.cu`` (``flash_prefill_bwd``), the port's own
kernel (the JAX package trains through plain XLA attention).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                 + [ctypes.c_void_p])
_BWD_ERR_SMEM = -1   # the launch's code for tiles past a block's shared memory


def flash_prefill(q, k, v, kv_len=None, *, causal: bool = True,
                  window: int = 0, attn_softcap: float = 0.0, scale=None):
    """q: (B,S,H,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv); kv_len: optional
    (B,) valid key counts.  Returns the normalized (B,S,H,Dv) in q's dtype;
    a query row with no valid key gives 0."""
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, kv_len, causal=causal,
                                     window=window, attn_softcap=attn_softcap,
                                     scale=scale)
    return _forward(q, k, v, kv_len, causal, window, attn_softcap, scale,
                    with_lse=False)[0]


def _kv_len(kv_len, B: int, Skv: int, device):
    if kv_len is None:
        return torch.full((B,), Skv, dtype=torch.int32, device=device)
    if kv_len.shape != (B,) or kv_len.device != device:
        raise ValueError(f"flash_prefill: kv_len must be (B,) on {device}")
    return kv_len.to(torch.int32).contiguous()


def _forward(q, k, v, kv_len, causal, window, attn_softcap, scale,
             with_lse: bool):
    """Launch the forward kernel: (o, lse), lse (B,H,S) f32 when asked for
    (each row's m + log l), else None."""
    B, S, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"flash_prefill kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if k.shape != (B, Skv, Hkv, D) or H % Hkv:
        raise ValueError(f"flash_prefill shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    build.require_operands("flash_prefill", q.dtype, q.device, q=q, k=k, v=v)
    if q.dtype == torch.bfloat16 and (
            D % 8 or Dv % 8 or D > 256 or Dv > 256
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(f"flash_prefill bf16 kernel takes D, Dv multiples "
                         f"of 8 up to 256 and 16-byte aligned q, k, v; got "
                         f"D {D}, Dv {Dv}")
    kv_len = _kv_len(kv_len, B, Skv, q.device)
    if scale is None:
        scale = D ** -0.5
    o = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B * S * H == 0:
        return o, lse
    fn = build.function("flash_prefill", "flash_prefill_launch", _ARGTYPES)
    err = fn(build.DTYPE_CODES[q.dtype], build.ptr(q), build.ptr(k),
             build.ptr(v), build.ptr(kv_len), build.ptr(o), B, S, Skv, H,
             Hkv, D, Dv, int(causal), int(window), float(scale),
             float(attn_softcap), build.stream(q.device),
             build.ptr(lse) if with_lse else None)
    build.check("flash_prefill", err)
    flash_prefill.launches += 1
    return o, lse


flash_prefill.launches = 0


def flash_prefill_bwd(q, k, v, o, lse, do, kv_len=None, *,
                      causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, scale=None):
    """The gradients (dq, dk, dv) of ``flash_prefill`` on CUDA tensors:
    q, k, v, o as the forward took and gave them, lse (B,H,S) f32 from the
    forward, do (B,S,H,Dv) the output's gradient, all contiguous and of
    q's dtype.  Launches ``csrc/flash_prefill_bwd.cu`` (a pre-pass for
    rowsum(do * o), the dQ kernel, the dK/dV kernel) or raises; a shape
    whose tiles do not fit a block's shared memory raises ValueError."""
    B, S, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    if q.device.type != "cuda":
        raise ValueError("flash_prefill_bwd launches on CUDA tensors; the "
                         "CPU differentiates the plain version")
    build.require_operands("flash_prefill_bwd", q.dtype, q.device, q=q, k=k,
                           v=v, o=o, do=do)
    build.require_operands("flash_prefill_bwd", torch.float32, q.device,
                           lse=lse)
    if (k.shape != (B, Skv, Hkv, D) or o.shape != (B, S, H, Dv)
            or do.shape != o.shape or lse.shape != (B, H, S) or H % Hkv):
        raise ValueError(f"flash_prefill_bwd shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, lse {tuple(lse.shape)}")
    kv_len = _kv_len(kv_len, B, Skv, q.device)
    if scale is None:
        scale = D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B * S * H == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = build.function("flash_prefill_bwd", "flash_prefill_bwd_launch",
                        _BWD_ARGTYPES)
    err = fn(build.DTYPE_CODES[q.dtype], build.ptr(q), build.ptr(k),
             build.ptr(v), build.ptr(o), build.ptr(do), build.ptr(lse),
             build.ptr(kv_len), build.ptr(delta), build.ptr(dq),
             build.ptr(dk), build.ptr(dv), B, S, Skv, H, Hkv, D, Dv,
             int(causal), int(window), float(scale), float(attn_softcap),
             build.stream(q.device))
    if err == _BWD_ERR_SMEM:
        raise ValueError(f"flash_prefill_bwd: the tiles of D {D}, Dv {Dv} "
                         f"do not fit a block's shared memory")
    build.check("flash_prefill_bwd", err)
    flash_prefill_bwd.launches += 1
    return dq, dk, dv


flash_prefill_bwd.launches = 0


class FlashPrefillFn(torch.autograd.Function):
    """``flash_prefill`` on CUDA tensors under autograd: the forward kernel
    with the rows' log-sum-exp saved, the backward kernel for the
    gradients.  Neither falls back to the plain version: a shape either
    kernel refuses raises.  ``apply(q, k, v, kv_len, causal, window,
    attn_softcap, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, window, attn_softcap, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _forward(q, k, v, kv_len, causal, window, attn_softcap,
                          scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, kv_len)
        ctx.kw = dict(causal=causal, window=window,
                      attn_softcap=attn_softcap, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, o, lse, do.contiguous(),
                                       kv_len, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
