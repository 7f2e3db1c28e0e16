"""Flash-decode GQA over a dense KV ring: the wrapper of
``csrc/gqa_decode.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/gqa_decode.py::gqa_decode``,
its int8 branch included.
On the H100 it is bound by the K and V bytes of the valid slots
(nvalid·Hkv·(D+Dv)·2 in bf16, ·1 plus 8 bytes of scales per slot and head
in int8); see the source for the design.  bf16 queries take the
tensor-core body (D and Dv multiples of 8 up to 256, 16-byte aligned
q, k, v — 8-byte aligned int8 k, v; the wrapper raises on others), float32
the CUDA-core body; either reads a bf16/f32 ring of the queries' dtype or
an int8 ring with its k_scale/v_scale (B,W,Hkv) f32 planes.  A CPU tensor
takes the plain version (``ref.gqa_decode_ref``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

W_CHUNK = 64     # ring slots per block; the chunks' partials merge after
MAX_D = 256      # D and Dv the bf16 body takes, at most

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def gqa_decode(q, k, v, valid, *, scale: float, attn_softcap: float = 0.0,
               k_scale=None, v_scale=None):
    """q: (B,H,D); k: (B,W,Hkv,D); v: (B,W,Hkv,Dv); valid: (B,W) bool.
    An int8 ring passes k_scale/v_scale (B,W,Hkv) f32.
    Returns (o_unnorm (B,H,Dv) f32, m (B,H) f32, l (B,H) f32)."""
    if q.device.type == "cpu":
        return ref.gqa_decode_ref(q, k, v, valid, scale=scale,
                                  attn_softcap=attn_softcap, k_scale=k_scale,
                                  v_scale=v_scale)
    B, H, D = q.shape
    _, W, Hkv, Dv = v.shape
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"gqa_decode kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if k.shape != (B, W, Hkv, D) or valid.shape != (B, W) or H % Hkv:
        raise ValueError(f"gqa_decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"valid {tuple(valid.shape)}")
    q8 = k.dtype == torch.int8
    if q8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("gqa_decode: an int8 ring takes k_scale and "
                         "v_scale, and only an int8 ring does")
    build.require_operands("gqa_decode", q.dtype, q.device, q=q)
    build.require_operands("gqa_decode", k.dtype if q8 else q.dtype,
                           q.device, k=k, v=v)
    build.require_operands("gqa_decode", torch.bool, q.device, valid=valid)
    if q8:
        if k_scale.shape != (B, W, Hkv) or v_scale.shape != (B, W, Hkv):
            raise ValueError(f"gqa_decode: k_scale/v_scale must be "
                             f"{(B, W, Hkv)}")
        build.require_operands("gqa_decode", torch.float32, q.device,
                               k_scale=k_scale, v_scale=v_scale)
    if q.dtype == torch.bfloat16 and (
            D % 8 or Dv % 8 or max(D, Dv) > MAX_D or q.data_ptr() % 16
            or any(t.data_ptr() % (8 if q8 else 16) for t in (k, v))):
        raise ValueError(f"gqa_decode bf16 kernel takes D, Dv multiples of "
                         f"8 up to {MAX_D}, a 16-byte aligned q and 16-byte "
                         f"(int8: 8-byte) aligned k, v; got D {D}, Dv {Dv}")
    dev = q.device
    o = torch.empty((B, H, Dv), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * H == 0:
        return o, m, l
    nsplit = max(1, -(-W // W_CHUNK))
    po = torch.empty((B, H, nsplit, Dv), dtype=torch.float32, device=dev)
    pm = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    pl = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    fn = build.function("gqa_decode", "gqa_decode_launch", _ARGTYPES)
    err = fn(build.DTYPE_CODES[q.dtype], build.ptr(q), build.ptr(k),
             build.ptr(v), build.ptr(valid),
             build.ptr(k_scale) if q8 else None,
             build.ptr(v_scale) if q8 else None, build.ptr(po), build.ptr(pm),
             build.ptr(pl), build.ptr(o), build.ptr(m), build.ptr(l),
             B, H, Hkv, W, D, Dv, W_CHUNK, float(scale),
             float(attn_softcap), build.stream(dev))
    build.check("gqa_decode", err)
    gqa_decode.launches += 1
    return o, m, l


gqa_decode.launches = 0
