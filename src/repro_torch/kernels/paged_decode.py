"""Paged flash-decode GQA through the page table of the block-paged KV
arena: the wrapper of ``csrc/paged_decode.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::paged_gqa_decode``.  On the H100 it is
bound by the K and V bytes of the mapped blocks; see the source for the
design.  A CPU tensor takes the plain version (``ref.paged_gqa_decode_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

BLOCKS_PER_SPLIT = 8   # logical blocks per thread block; chunks merge after
GROUPS = (1, 2, 4, 8)  # query heads per kv head the kernel is built for
VPLS = (1, 2, 4)       # D columns per lane: D <= 128

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def paged_gqa_decode(q, k, v, slot_pos, page_table, pos, *, scale: float,
                     attn_softcap: float = 0.0, window: int = 0,
                     k_scale=None, v_scale=None, k_new=None, v_new=None):
    """q: (B,H,D); k/v: (Hkv, NB+1, bt, D) head-major arena of one layer
    (the last block is the trash block, never read); slot_pos: (NB+1, bt)
    int32; page_table: (B, MB) int32 (-1 = unmapped); pos: (B,) int32.
    The fused decode-write form passes the fresh token k_new/v_new
    (B, Hkv, D) in the arena dtype; it is merged into its target block
    in registers and the arena is not written.  Returns partials
    (o_unnorm (B,H,D) f32, m (B,H) f32, l (B,H) f32)."""
    if k_scale is not None or v_scale is not None or k.dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV is not ported to paged_gqa_decode yet")
    if q.device.type == "cpu":
        cache = {"k": k, "v": v, "slot_pos": slot_pos,
                 "page_table": page_table}
        return ref.paged_gqa_decode_ref(q, cache, pos, scale=scale,
                                        attn_softcap=attn_softcap,
                                        window=window, k_new=k_new,
                                        v_new=v_new)
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
    vpl = next((n for n in VPLS if 32 * n >= D), None)
    if H // Hkv not in GROUPS or vpl is None or D % vpl:
        raise ValueError(f"paged_gqa_decode kernel takes H/Hkv in {GROUPS} "
                         f"and D <= 128 (a multiple of D/32 rounded up to "
                         f"1, 2 or 4), got H {H}, Hkv {Hkv}, D {D}")
    dev = q.device
    kv = dict(q=q, k=k, v=v)
    if fused:
        kv.update(k_new=k_new, v_new=v_new)
    build.require_operands("paged_gqa_decode", q.dtype, dev, **kv)
    build.require_operands("paged_gqa_decode", torch.int32, dev,
                           slot_pos=slot_pos, page_table=page_table, pos=pos)
    align = vpl * q.element_size()
    if any(t.data_ptr() % align for t in kv.values()):
        raise ValueError(f"paged_gqa_decode: q, k, v (and k_new, v_new) "
                         f"must be aligned to {align} bytes")
    o = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * H == 0:
        return o, m, l
    nsplit = -(-MB // BLOCKS_PER_SPLIT)
    po = torch.empty((B, H, nsplit, D), dtype=torch.float32, device=dev)
    pm = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    pl = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    fn = build.function("paged_decode", "paged_gqa_decode_launch", _ARGTYPES)
    err = fn(build.DTYPE_CODES[q.dtype], build.ptr(q), build.ptr(k),
             build.ptr(v), build.ptr(slot_pos), build.ptr(page_table),
             build.ptr(pos),
             build.ptr(k_new) if fused else None,
             build.ptr(v_new) if fused else None,
             build.ptr(po), build.ptr(pm), build.ptr(pl), build.ptr(o),
             build.ptr(m), build.ptr(l), B, H, Hkv, NB1, bt, D, MB,
             BLOCKS_PER_SPLIT, vpl, float(scale), float(attn_softcap),
             int(window), build.stream(dev))
    build.check("paged_decode", err)
    paged_gqa_decode.launches += 1
    return o, m, l


paged_gqa_decode.launches = 0
