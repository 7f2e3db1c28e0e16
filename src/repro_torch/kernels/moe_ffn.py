"""Grouped gated expert FFN: the wrapper of ``csrc/moe_ffn.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/moe_ffn.py::moe_ffn``, its
int8 weight path included.  On the H100 it is bound by the weight bytes of
the experts that hold a token at decode (D·3F·2 each in bf16, D·3F in
int8) and by bytes or operations at prefill; see the source for the
design.  bf16 activations take the tensor-core body, which skips the
bucket tiles that hold only zeros (their outputs are exactly 0); float32
takes the CUDA-core body.  Either takes weights of the activations' dtype
or int8 weights (weight-only quantization, per-expert f32 scales applied
to the product tiles), which stay int8 in device memory.  A CPU tensor takes the plain version
(``ref.moe_ffn_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ACTS = {"silu": 0, "gelu": 1}
_THREADS = 128           # columns per block (csrc/moe_ffn.cu kThreads)
_TARGET_BLOCKS = 1056    # ~8 blocks per SM for the f32 down pass

# both launch functions: 8 pointers, 8 ints, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _rows_per_block(C: int) -> int:
    """f32 body: bucket rows per block."""
    return 4 if C <= 4 else (8 if C <= 8 else 32)


def _f_split(E: int, C: int, D: int, ct: int) -> int:
    base = -(-D // _THREADS) * -(-C // ct) * E
    return max(1, min(16, -(-_TARGET_BLOCKS // base)))


def _row_tile(C: int) -> int:
    """bf16 body: bucket rows per block (the mma.sync N side)."""
    return next((n for n in (8, 16, 32, 64) if C <= n), 128)


def moe_ffn(xbuf, wi, wo, wi_scale=None, wo_scale=None, *, act: str = "silu"):
    """xbuf: (E,C,D); wi: (E,D,2,F); wo: (E,F,D) -> (E,C,D) in xbuf's dtype.
    wi_scale / wo_scale: optional per-expert (E,) scales, applied (in f32)
    to the gate/up and down products; wi / wo may be int8 (weight-only
    quantization)."""
    if xbuf.device.type == "cpu":
        return ref.moe_ffn_ref(xbuf, wi, wo, wi_scale, wo_scale, act=act)
    E, C, D = xbuf.shape
    F = wo.shape[1]
    w8 = wi.dtype == torch.int8
    if xbuf.dtype not in build.DTYPE_CODES:
        raise TypeError(f"moe_ffn kernel takes float32/bfloat16, got "
                        f"{xbuf.dtype}")
    if wi.shape != (E, D, 2, F) or wo.shape != (E, F, D):
        raise ValueError(f"moe_ffn shapes: xbuf {tuple(xbuf.shape)}, "
                         f"wi {tuple(wi.shape)}, wo {tuple(wo.shape)}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {tuple(_ACTS)}, got {act!r}")
    build.require_operands("moe_ffn", xbuf.dtype, xbuf.device, xbuf=xbuf)
    build.require_operands("moe_ffn", torch.int8 if w8 else xbuf.dtype,
                           xbuf.device, wi=wi, wo=wo)
    # the kernels read f32 scales; a bf16 model's shared span holds them
    # rounded to bf16 (core/paging.py), exact in f32
    held = {}
    for name, s in (("wi_scale", wi_scale), ("wo_scale", wo_scale)):
        if s is not None:
            if s.shape != (E,):
                raise ValueError(f"moe_ffn: {name} must have shape (E,)")
            held[name] = s.float().contiguous()
    build.require_operands("moe_ffn", torch.float32, xbuf.device, **held)
    scales = [build.ptr(held[n]) if n in held else None
              for n in ("wi_scale", "wo_scale")]
    if xbuf.dtype == torch.bfloat16:
        if D % 8 or any(t.data_ptr() % 16 for t in (xbuf, wi, wo)):
            raise ValueError(f"moe_ffn bf16 kernel needs D % 8 == 0 (got "
                             f"{D}) and 16-byte aligned xbuf, wi and wo")
    out = torch.empty_like(xbuf)
    if E * C * D == 0:
        return out
    dev = xbuf.device
    if xbuf.dtype == torch.bfloat16:
        nt = _row_tile(C)
        fp = -(-F // 8) * 8
        hid = torch.empty((E, C, fp), dtype=torch.bfloat16, device=dev)
        flags = torch.empty((E, C), dtype=torch.int32, device=dev)
        fn = build.function("moe_ffn", "moe_ffn_bf16_launch", _ARGTYPES)
        err = fn(build.ptr(xbuf), build.ptr(wi), build.ptr(wo), scales[0],
                 scales[1], build.ptr(out), build.ptr(hid), build.ptr(flags),
                 E, C, D, F, fp, nt, _ACTS[act], int(w8), build.stream(dev))
    else:
        ct = _rows_per_block(C)
        fsplit = _f_split(E, C, D, ct)
        hid = torch.empty((E, C, F), dtype=torch.float32, device=dev)
        part = torch.empty((fsplit, E, C, D), dtype=torch.float32, device=dev)
        fn = build.function("moe_ffn", "moe_ffn_f32_launch", _ARGTYPES)
        err = fn(build.ptr(xbuf), build.ptr(wi), build.ptr(wo), scales[0],
                 scales[1], build.ptr(out), build.ptr(hid), build.ptr(part),
                 E, C, D, F, ct, fsplit, _ACTS[act], int(w8),
                 build.stream(dev))
    build.check("moe_ffn", err)
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0
