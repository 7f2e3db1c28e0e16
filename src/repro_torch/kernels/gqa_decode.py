"""Flash-decode GQA over a dense KV ring: the wrapper of
``csrc/gqa_decode.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/gqa_decode.py::gqa_decode``.
On the H100 it is bound by the K and V bytes of the valid slots
(nvalid·Hkv·(D+Dv)·2 in bf16); see the source for the design.  A CPU tensor takes the plain version
(``ref.gqa_decode_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

W_CHUNK = 64     # ring slots per block; the chunks' partials merge after

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def gqa_decode(q, k, v, valid, *, scale: float, attn_softcap: float = 0.0,
               k_scale=None, v_scale=None):
    """q: (B,H,D); k: (B,W,Hkv,D); v: (B,W,Hkv,Dv); valid: (B,W) bool.
    Returns (o_unnorm (B,H,Dv) f32, m (B,H) f32, l (B,H) f32)."""
    if k_scale is not None or v_scale is not None or k.dtype == torch.int8:
        raise NotImplementedError("int8 KV is not ported to gqa_decode yet")
    if q.device.type == "cpu":
        return ref.gqa_decode_ref(q, k, v, valid, scale=scale,
                                  attn_softcap=attn_softcap)
    B, H, D = q.shape
    _, W, Hkv, Dv = v.shape
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"gqa_decode kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    if k.shape != (B, W, Hkv, D) or valid.shape != (B, W) or H % Hkv:
        raise ValueError(f"gqa_decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"valid {tuple(valid.shape)}")
    build.require_operands("gqa_decode", q.dtype, q.device, q=q, k=k, v=v)
    build.require_operands("gqa_decode", torch.bool, q.device, valid=valid)
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
             build.ptr(v), build.ptr(valid), build.ptr(po), build.ptr(pm),
             build.ptr(pl), build.ptr(o), build.ptr(m), build.ptr(l),
             B, H, Hkv, W, D, Dv, W_CHUNK, float(scale),
             float(attn_softcap), build.stream(dev))
    build.check("gqa_decode", err)
    gqa_decode.launches += 1
    return o, m, l


gqa_decode.launches = 0
