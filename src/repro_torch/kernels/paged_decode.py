"""Paged flash-decode GQA through the page table of the block-paged KV
arena: the wrapper of ``csrc/paged_decode.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::paged_gqa_decode``, its int8 branch
included.  On the H100 it is bound by the K and V bytes of the mapped
blocks (an int8 arena: half of them, plus one f32 scale per position and
head); see the source for the design.  An int8 arena (int8 k, v with
k_scale/v_scale planes) takes either body, read as int8 from HBM.  bf16 takes the tensor-core body: any H/Hkv, D a multiple of 8 up
to 256, any block size and page-table width, 16-byte aligned q, k, v (and
k_new, v_new).  float32 takes the CUDA-core body: H/Hkv in {1, 2, 4, 8}
and D <= 128.  The wrapper raises on others.  The source sizes the chunks
of a row whose partials merge after (``paged_gqa_decode_splits``), so the
launch depends on the shapes alone and reads nothing back from the device.
A CPU tensor takes the plain version (``ref.paged_gqa_decode_ref``); a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_D = 256            # D the bf16 body takes, at most
MAX_SPLITS = 65535     # chunks of a row, at most (a grid dimension)
F32_GROUPS = (1, 2, 4, 8)  # H/Hkv the float32 body is built for
F32_VPLS = (1, 2, 4)       # its D columns per lane: D <= 128

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def paged_gqa_decode(q, k, v, slot_pos, page_table, pos, *, scale: float,
                     attn_softcap: float = 0.0, window: int = 0,
                     k_scale=None, v_scale=None, k_new=None, v_new=None,
                     k_scale_new=None, v_scale_new=None):
    """q: (B,H,D); k/v: (Hkv, NB+1, bt, D) head-major arena of one layer
    (the last block is the trash block, never read); slot_pos: (NB+1, bt)
    int32; page_table: (B, MB) int32 (-1 = unmapped); pos: (B,) int32.
    An int8 arena passes k_scale/v_scale (Hkv, NB+1, bt) f32.
    The fused decode-write form passes the fresh token k_new/v_new
    (B, Hkv, D) in the arena dtype (and, for int8, k_scale_new/v_scale_new
    (B, Hkv) f32); it takes the place of its arena row as the kernel
    stages its tile, and the arena is not written.
    Returns partials (o_unnorm (B,H,D) f32, m (B,H) f32, l (B,H) f32)."""
    if q.device.type == "cpu":
        cache = {"k": k, "v": v, "slot_pos": slot_pos,
                 "page_table": page_table}
        if k_scale is not None:
            cache.update(k_scale=k_scale, v_scale=v_scale)
        return ref.paged_gqa_decode_ref(q, cache, pos, scale=scale,
                                        attn_softcap=attn_softcap,
                                        window=window, k_new=k_new,
                                        v_new=v_new, k_scale_new=k_scale_new,
                                        v_scale_new=v_scale_new)
    B, H, D = q.shape
    Hkv, NB1, bt, Dk = k.shape
    MB = page_table.shape[1]
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"paged_gqa_decode kernel takes float32/bfloat16, "
                        f"got {q.dtype}")
    fused = k_new is not None
    if (Dk != D or v.shape != k.shape or slot_pos.shape != (NB1, bt)
            or page_table.shape != (B, MB) or pos.shape != (B,)
            or H % Hkv or (fused and (k_new.shape != (B, Hkv, D)
                                      or v_new is None
                                      or v_new.shape != (B, Hkv, D)))):
        raise ValueError(f"paged_gqa_decode shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"slot_pos {tuple(slot_pos.shape)}, page_table "
                         f"{tuple(page_table.shape)}, pos {tuple(pos.shape)}")
    dev = q.device
    q8 = k.dtype == torch.int8
    if q8 != (k_scale is not None) or (k_scale is None) != (v_scale is None) \
            or (fused and q8 != (k_scale_new is not None)) \
            or (k_scale_new is None) != (v_scale_new is None):
        raise ValueError("paged_gqa_decode: an int8 arena takes k_scale and "
                         "v_scale (and, fused, k_scale_new and v_scale_new), "
                         "and only an int8 arena does")
    kv = dict(k=k, v=v)
    if fused:
        kv.update(k_new=k_new, v_new=v_new)
    build.require_operands("paged_gqa_decode", q.dtype, dev, q=q)
    build.require_operands("paged_gqa_decode", k.dtype if q8 else q.dtype,
                           dev, **kv)
    build.require_operands("paged_gqa_decode", torch.int32, dev,
                           slot_pos=slot_pos, page_table=page_table, pos=pos)
    scales = {}
    if q8:
        scales = dict(k_scale=k_scale, v_scale=v_scale)
        if k_scale.shape != (Hkv, NB1, bt) or v_scale.shape != (Hkv, NB1, bt):
            raise ValueError(f"paged_gqa_decode: k_scale/v_scale must be "
                             f"{(Hkv, NB1, bt)}")
        if fused:
            scales.update(k_scale_new=k_scale_new, v_scale_new=v_scale_new)
            if k_scale_new.shape != (B, Hkv) or v_scale_new.shape != (B, Hkv):
                raise ValueError(f"paged_gqa_decode: k_scale_new/"
                                 f"v_scale_new must be {(B, Hkv)}")
        build.require_operands("paged_gqa_decode", torch.float32, dev,
                               **scales)
    if q.dtype == torch.bfloat16:
        vpl, align = 0, 16
        if D % 8 or D > MAX_D:
            raise ValueError(f"paged_gqa_decode bf16 kernel takes D a "
                             f"multiple of 8 up to {MAX_D}, got D {D}")
    else:
        vpl = next((n for n in F32_VPLS if 32 * n >= D), None)
        if H // Hkv not in F32_GROUPS or vpl is None or D % vpl:
            raise ValueError(f"paged_gqa_decode float32 kernel takes H/Hkv "
                             f"in {F32_GROUPS} and D <= 128 (a multiple of "
                             f"D/32 rounded up to 1, 2 or 4), got H {H}, "
                             f"Hkv {Hkv}, D {D}")
        align = 4 * vpl
    kv_align = (align // q.element_size()) if q8 else align
    if q.data_ptr() % align or any(t.data_ptr() % kv_align
                                   for t in kv.values()):
        raise ValueError(f"paged_gqa_decode: q must be aligned to {align} "
                         f"bytes, k, v (and k_new, v_new) to {kv_align}")
    o = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * H == 0:
        return o, m, l
    # the chunks of a row, as the source sizes them
    dtype = build.DTYPE_CODES[q.dtype]
    nsplit = build.function("paged_decode", "paged_gqa_decode_splits",
                            [ctypes.c_int] * 3)(dtype, MB, bt)
    if nsplit > MAX_SPLITS:
        raise ValueError(f"paged_gqa_decode {q.dtype} kernel takes at most "
                         f"{MAX_SPLITS} chunks a row, got {nsplit} for {MB} "
                         f"blocks of {bt} positions")
    po = torch.empty((B, H, nsplit, D), dtype=torch.float32, device=dev)
    pm = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    pl = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    fn = build.function("paged_decode", "paged_gqa_decode_launch", _ARGTYPES)
    err = fn(dtype, build.ptr(q), build.ptr(k), build.ptr(v),
             build.ptr(slot_pos), build.ptr(page_table), build.ptr(pos),
             build.ptr(k_new) if fused else None,
             build.ptr(v_new) if fused else None,
             *[build.ptr(scales[n]) if n in scales else None
               for n in ("k_scale", "v_scale", "k_scale_new",
                         "v_scale_new")],
             build.ptr(po), build.ptr(pm), build.ptr(pl), build.ptr(o),
             build.ptr(m), build.ptr(l), B, H, Hkv, NB1, bt, D, MB, vpl,
             float(scale), float(attn_softcap), int(window),
             build.stream(dev))
    build.check("paged_decode", err)
    paged_gqa_decode.launches += 1
    return o, m, l


paged_gqa_decode.launches = 0
