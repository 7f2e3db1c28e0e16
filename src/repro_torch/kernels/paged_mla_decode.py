"""Paged absorbed-MLA decode through the page table of the latent arena:
the wrapper of ``csrc/paged_mla_decode.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/paged_decode.py::paged_mla_decode``.  On the H100 it is
bound by its bytes (the mapped blocks' latents, qcat and the f32 partials);
its products, a real GEMM for 128 heads, run on the tensor cores in bf16
with f32 accumulation, so they are far from the operation bound; see the
source for the design.  bf16 takes the tensor-core body, float32 the
CUDA-core body; both take lat and dr in 16-byte multiples with lat <= 512
and lat + dr <= 576, any page-table width, and the float32 body blocks of
at most 128 positions (the wrapper raises on others).  The source sizes
the chunks of a row whose partials merge after
(``paged_mla_decode_splits``).  A CPU tensor takes the plain version
(``ref.paged_mla_decode_ref``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_D = 576            # lat + dr the kernel takes, at most
MAX_LAT = 512

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def paged_mla_decode(qcat, ckv, kr, slot_pos, page_table, pos, *,
                     scale: float, ckv_new=None, kr_new=None):
    """qcat: (B,H,lat+dr) absorbed latent queries ++ rope queries; ckv:
    (NB+1, bt, lat) and kr: (NB+1, bt, dr) latent arena of one layer (the
    last block is the trash block, never read); slot_pos: (NB+1, bt)
    int32; page_table: (B, MB) int32 (-1 = unmapped); pos: (B,) int32.
    The fused decode-write form passes the fresh latents ckv_new (B, lat) /
    kr_new (B, dr) in the arena dtype; they are merged into their target
    block as it is staged and the arena is not written.  Returns partials
    (o_unnorm (B,H,lat) f32, m (B,H) f32, l (B,H) f32)."""
    if qcat.device.type == "cpu":
        cache = {"ckv": ckv, "kr": kr, "slot_pos": slot_pos,
                 "page_table": page_table}
        return ref.paged_mla_decode_ref(qcat, cache, pos, scale=scale,
                                        ckv_new=ckv_new, kr_new=kr_new)
    B, H, Dq = qcat.shape
    NB1, bt, L = ckv.shape
    R = kr.shape[-1]
    MB = page_table.shape[1]
    if qcat.dtype not in build.DTYPE_CODES:
        raise TypeError(f"paged_mla_decode kernel takes float32/bfloat16, "
                        f"got {qcat.dtype}")
    fused = ckv_new is not None
    if (Dq != L + R or kr.shape != (NB1, bt, R)
            or slot_pos.shape != (NB1, bt) or page_table.shape != (B, MB)
            or pos.shape != (B,)
            or (fused and (ckv_new.shape != (B, L) or kr_new is None
                           or kr_new.shape != (B, R)))):
        raise ValueError(f"paged_mla_decode shapes: qcat {tuple(qcat.shape)}, "
                         f"ckv {tuple(ckv.shape)}, kr {tuple(kr.shape)}, "
                         f"slot_pos {tuple(slot_pos.shape)}, page_table "
                         f"{tuple(page_table.shape)}, pos {tuple(pos.shape)}")
    vec = 16 // qcat.element_size()
    if L % vec or R % vec or L + R > MAX_D or L > MAX_LAT:
        raise ValueError(f"paged_mla_decode kernel takes lat and dr in "
                         f"multiples of {vec}, lat <= {MAX_LAT} and lat + dr "
                         f"<= {MAX_D}; got lat {L}, dr {R}")
    dev = qcat.device
    data = dict(qcat=qcat, ckv=ckv, kr=kr)
    if fused:
        data.update(ckv_new=ckv_new, kr_new=kr_new)
    build.require_operands("paged_mla_decode", qcat.dtype, dev, **data)
    build.require_operands("paged_mla_decode", torch.int32, dev,
                           slot_pos=slot_pos, page_table=page_table, pos=pos)
    if any(t.data_ptr() % 16 for t in data.values()):
        raise ValueError("paged_mla_decode: qcat, ckv, kr (and ckv_new, "
                         "kr_new) must be aligned to 16 bytes")
    o = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B * H == 0:
        return o, m, l
    # the chunks of a row, as the source sizes them (0: bt not taken)
    dtype = build.DTYPE_CODES[qcat.dtype]
    nsplit = build.function("paged_mla_decode", "paged_mla_decode_splits",
                            [ctypes.c_int] * 3)(dtype, MB, bt)
    if nsplit < 1:
        raise ValueError(f"paged_mla_decode {qcat.dtype} kernel does not "
                         f"take {MB} blocks of {bt} positions")
    po = torch.empty((B, H, nsplit, L), dtype=torch.float32, device=dev)
    pm = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    pl = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    fn = build.function("paged_mla_decode", "paged_mla_decode_launch",
                        _ARGTYPES)
    err = fn(dtype, build.ptr(qcat), build.ptr(ckv),
             build.ptr(kr), build.ptr(slot_pos), build.ptr(page_table),
             build.ptr(pos),
             build.ptr(ckv_new) if fused else None,
             build.ptr(kr_new) if fused else None,
             build.ptr(po), build.ptr(pm), build.ptr(pl), build.ptr(o),
             build.ptr(m), build.ptr(l), B, H, bt, L, R, MB, float(scale),
             build.stream(dev))
    build.check("paged_mla_decode", err)
    paged_mla_decode.launches += 1
    return o, m, l


paged_mla_decode.launches = 0
