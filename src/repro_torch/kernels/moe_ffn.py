"""Grouped gated expert FFN: the wrapper of ``csrc/moe_ffn.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_ffn.py::moe_ffn``.  On the
H100 it is bound by the expert weight bytes at decode (E·D·3F·2 in bf16, one
read per bucket tile) and by operations at prefill; see the source for the
design.  A CPU tensor takes the plain version (``ref.moe_ffn_ref``); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ACTS = {"silu": 0, "gelu": 1}
_THREADS = 128           # columns per block (csrc/moe_ffn.cu kThreads)
_TARGET_BLOCKS = 1056    # ~8 blocks per SM for the down pass

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def _rows_per_block(C: int) -> int:
    return 4 if C <= 4 else (8 if C <= 8 else 32)


def _f_split(E: int, C: int, D: int, ct: int) -> int:
    base = -(-D // _THREADS) * -(-C // ct) * E
    return max(1, min(16, -(-_TARGET_BLOCKS // base)))


def moe_ffn(xbuf, wi, wo, wi_scale=None, wo_scale=None, *, act: str = "silu"):
    """xbuf: (E,C,D); wi: (E,D,2,F); wo: (E,F,D) -> (E,C,D) in xbuf's dtype.
    wi_scale / wo_scale: optional per-expert (E,) f32 scales, applied to the
    gate/up and down products."""
    if xbuf.device.type == "cpu":
        return ref.moe_ffn_ref(xbuf, wi, wo, wi_scale, wo_scale, act=act)
    E, C, D = xbuf.shape
    F = wo.shape[1]
    if wi.dtype == torch.int8 or wo.dtype == torch.int8:
        raise NotImplementedError("int8 expert weights are not supported by "
                                  "the CUDA moe_ffn kernel yet")
    if xbuf.dtype not in build.DTYPE_CODES:
        raise TypeError(f"moe_ffn kernel takes float32/bfloat16, got "
                        f"{xbuf.dtype}")
    if wi.shape != (E, D, 2, F) or wo.shape != (E, F, D):
        raise ValueError(f"moe_ffn shapes: xbuf {tuple(xbuf.shape)}, "
                         f"wi {tuple(wi.shape)}, wo {tuple(wo.shape)}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {tuple(_ACTS)}, got {act!r}")
    build.require_operands("moe_ffn", xbuf.dtype, xbuf.device, xbuf=xbuf,
                           wi=wi, wo=wo)
    scales = []
    for name, s in (("wi_scale", wi_scale), ("wo_scale", wo_scale)):
        if s is not None:
            if s.shape != (E,):
                raise ValueError(f"moe_ffn: {name} must have shape (E,)")
            build.require_operands("moe_ffn", torch.float32, xbuf.device,
                                   **{name: s})
        scales.append(build.ptr(s) if s is not None else None)
    out = torch.empty_like(xbuf)
    if E * C * D == 0:
        return out
    ct = _rows_per_block(C)
    fsplit = _f_split(E, C, D, ct)
    hid = torch.empty((E, C, F), dtype=torch.float32, device=xbuf.device)
    part = torch.empty((fsplit, E, C, D), dtype=torch.float32,
                       device=xbuf.device)
    fn = build.function("moe_ffn", "moe_ffn_launch", _ARGTYPES)
    err = fn(build.DTYPE_CODES[xbuf.dtype], build.ptr(xbuf), build.ptr(wi),
             build.ptr(wo), scales[0], scales[1], build.ptr(out),
             build.ptr(hid), build.ptr(part), E, C, D, F, ct, fsplit,
             _ACTS[act], build.stream(xbuf.device))
    build.check("moe_ffn", err)
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0
