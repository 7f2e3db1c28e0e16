"""Expert-span gather of the expert-granular paged weights: the wrapper of
``csrc/expert_gather.cu``.

The port's own kernel, with no Pallas counterpart: it replaces the XLA
gather that ``repro/models/model.py::_ExpertCtx.make_fetch`` lowers to.
For one layer it fetches the activated experts' spans — resident ones from
the device pool, misses from the pinned host store over the link — and
writes each span leaf as a contiguous (A, ...) tensor (``moe_ffn``'s
operands); pad slots (a >= n_act) are zero.  A CPU tensor takes the plain
version (``ref.expert_gather_ref``); a CUDA tensor launches the kernel or
raises.

On the card the device decides which spans move and the copy engine moves
them: a one-thread kernel reads ``sel``, ``n_act`` and the resident map and
writes the misses into a plan in mapped host memory, and the gather kernel
copies the resident slots and zero-fills the pads.  The launch waits for
the stream to reach the plan (the GIL is released meanwhile), enqueues one
``cudaMemcpyAsync`` per missed leaf on a copy stream of the library, beside
the gather kernel, and makes the caller's stream wait for them; it returns
without waiting for the copies.  So a call blocks the host until the
device has run everything enqueued before it, once per layer
(``csrc/expert_gather.cu``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import paging
from repro_torch.kernels import build, ref

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def expert_gather(store, pool, resident_map, layer: int, sel, n_act,
                  manifest):
    """store: (L, E, ppe, pe) host store (pinned for a CUDA engine);
    pool: (slots, ppe, pe) on the device, or None (nothing resident);
    resident_map: (L, E) int32, -1 = not resident; sel: (A,) int32 expert
    ids; n_act: () int32, the real slots.  Returns the manifest's leaves
    as contiguous (A, *leaf_shape) tensors, in a tree keyed like the
    ``moe`` params; on the card the misses' copies may still be in flight
    when it returns (the current stream waits for them)."""
    if sel.device.type == "cpu":
        return ref.expert_gather_ref(store, pool, resident_map, layer, sel,
                                     n_act, manifest)
    dev = sel.device
    L, E, ppe, pe = store.shape
    A = sel.shape[0]
    if store.device.type != "cpu" or not store.is_pinned():
        raise ValueError("expert_gather: the store must be pinned host "
                         "memory (core.offload.weight_store)")
    if not store.is_contiguous():
        raise ValueError("expert_gather: the store must be contiguous")
    if pool is not None:
        if pool.shape[1:] != (ppe, pe) or pool.dtype != store.dtype:
            raise ValueError(f"expert_gather: pool {tuple(pool.shape)} "
                             f"{pool.dtype} does not hold spans of store "
                             f"{tuple(store.shape)} {store.dtype}")
        build.require_operands("expert_gather", store.dtype, dev, pool=pool)
    if resident_map.shape != (L, E) or not 0 <= layer < L:
        raise ValueError(f"expert_gather: map {tuple(resident_map.shape)}, "
                         f"layer {layer} for a store of {L} x {E} spans")
    build.require_operands("expert_gather", torch.int32, dev,
                           resident_map=resident_map, sel=sel,
                           n_act=n_act.reshape(1))
    outs = {e: torch.empty((A,) + e.shape, dtype=store.dtype, device=dev)
            for e in manifest.leaves}
    item = store.element_size()
    n = len(outs)
    offs = (ctypes.c_longlong * n)(*[e.offset * item for e in outs])
    ns = (ctypes.c_longlong * n)(*[math.prod(e.shape) * item for e in outs])
    ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs.values()])
    fn = build.function("expert_gather", "expert_gather_launch", _ARGTYPES)
    err = fn(build.ptr(store), build.ptr(pool) if pool is not None else None,
             build.ptr(resident_map), build.ptr(sel), build.ptr(n_act),
             ctypes.cast(offs, ctypes.c_void_p),
             ctypes.cast(ns, ctypes.c_void_p),
             ctypes.cast(ptrs, ctypes.c_void_p), n, layer, E, A,
             ppe * pe * item, item, build.stream(dev))
    build.check("expert_gather", err)
    expert_gather.launches += 1
    return paging.tree_from_leaves([(e.path, o) for e, o in outs.items()])


expert_gather.launches = 0
