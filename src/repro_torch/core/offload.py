"""The pinned host tier (``repro/core/offload.py``'s placement of host-side
stores): the paged KV pool's spilled blocks, and the packed weight pages of
the expert-granular path (``core.paging.PagedWeights``).

On the card a store is page-locked host memory, so that copies to and from
it are asynchronous DMA on a stream, and the expert gather kernel reads it
in place over the link.  A store that cannot be pinned raises: it never
turns quietly into pageable memory, whose copies are synchronous and run at
a fraction of the link's rate.  Where the engine runs on the CPU
(``device="cpu"``) a store is a plain CPU tensor.

Two ways to pin:

  * ``host_store`` (the KV tier, a few hundred MB) takes PyTorch's pinned
    allocator;
  * ``weight_store`` (the weight pages, up to ~90 GB for mixtral-8x7b)
    allocates pageable memory and page-locks exactly its bytes in place
    with ``cudaHostRegister``: PyTorch's caching host allocator rounds each
    allocation up to a power of two, so an 84 GiB store would ask for 128.
    ``release`` unregisters it (and so does dropping the tensor), and hands
    its pages back to the host at once (``madvise(MADV_DONTNEED)``), so
    that a later store can be drawn in the same memory even while some
    reference to the released tensor lives on: freeing a page-locked store
    returned its memory to ``MemAvailable`` only once every reference to
    the tensor had gone.
"""
from __future__ import annotations

import ctypes
import mmap
import weakref
from typing import Dict

import torch

from repro_torch.runtime.faults import HostMemoryError

# cudaHostRegisterPortable | cudaHostRegisterMapped: visible to every
# context and in the device's address space; page-locked, so the gather's
# copies of missed spans run on the copy engine
_REGISTER_FLAGS = 1 | 2
_registered: Dict[int, int] = {}          # data_ptr -> bytes page-locked


def host_store(shape, dtype: torch.dtype, device: torch.device,
               faults=None) -> torch.Tensor:
    """A zeroed host-side store for an engine on `device`: pinned for a
    CUDA device, plain for the CPU.  ``faults`` is an optional
    ``runtime.faults.FaultInjector``: its "host_alloc" site models a
    refused pinned allocation, drawn first, as the reference's placement
    probe draws it.  A refusal, injected or real (the allocation fails or
    comes back unpinned), raises ``HostMemoryError``."""
    if faults is not None:
        faults.raise_for("host_alloc")
    if device.type == "cpu":
        return torch.zeros(shape, dtype=dtype)
    if device.type != "cuda":
        raise ValueError(f"no host tier for device {device}")
    try:
        t = torch.empty(shape, dtype=dtype, pin_memory=True)
    except RuntimeError as e:
        raise HostMemoryError(f"pinned host store of {tuple(shape)} {dtype} "
                              f"refused: {e}", "host_alloc") from e
    if not t.is_pinned():
        raise HostMemoryError(f"host store of {tuple(shape)} {dtype} "
                              "was not pinned", "host_alloc")
    return t.zero_()


def pageable_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of host tensor `t` in pageable (not page-locked) memory."""
    out = torch.empty(t.shape, dtype=t.dtype)
    out.copy_(t)
    return out


_MADV_DONTNEED = 4


def _unregister(ptr: int) -> int:
    """Unpin a registered store; returns its bytes (0 if none was)."""
    nbytes = _registered.pop(ptr, None)
    if nbytes is None:
        return 0
    torch.cuda.cudart().cudaHostUnregister(ptr)
    return nbytes


def _discard(ptr: int, nbytes: int) -> None:
    """Drop the whole pages inside [ptr, ptr + nbytes) from the process:
    their memory goes back to the host now, and a later read of them
    gives zeros (the mapping stays valid until the allocation is freed)."""
    page = mmap.PAGESIZE
    lo = -(-ptr // page) * page
    hi = (ptr + nbytes) // page * page
    if hi > lo:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                 ctypes.c_int]
        if libc.madvise(lo, hi - lo, _MADV_DONTNEED) != 0:
            raise OSError(ctypes.get_errno(), "madvise(MADV_DONTNEED) failed")


def weight_store(shape, dtype: torch.dtype, device: torch.device
                 ) -> torch.Tensor:
    """An uninitialized host store of packed weight pages for an engine on
    `device` (every byte is written by ``PagedWeights.write_layer``): page-
    locked in place for a CUDA device, exactly its own bytes, raising if
    ``cudaHostRegister`` refuses; a plain CPU tensor for the CPU."""
    if device.type == "cpu":
        return torch.empty(shape, dtype=dtype)
    if device.type != "cuda":
        raise ValueError(f"no host store for device {device}")
    t = torch.empty(shape, dtype=dtype)
    ptr, nbytes = t.data_ptr(), t.nbytes
    err = torch.cuda.cudart().cudaHostRegister(ptr, nbytes, _REGISTER_FLAGS)
    if int(err) != 0 or not t.is_pinned():
        raise RuntimeError(f"cudaHostRegister refused {nbytes} bytes for a "
                           f"weight store of {tuple(shape)} {dtype} "
                           f"(error {int(err)})")
    _registered[ptr] = nbytes
    weakref.finalize(t, _unregister, ptr)
    return t


def release(t: torch.Tensor) -> None:
    """Unregister a ``weight_store`` and give its pages back to the host
    (no-op for any other tensor).  Waits for the device first; the tensor
    must not be read after this (it reads as zeros)."""
    if t.data_ptr() not in _registered:
        return
    torch.cuda.synchronize()
    _discard(t.data_ptr(), _unregister(t.data_ptr()))


def pinned_bytes() -> int:
    """Bytes page-locked by live ``weight_store``s."""
    return sum(_registered.values())


def copy_stream(device: torch.device):
    """A side stream for host-to-device weight copies on a CUDA device
    (None on the CPU, where copies are synchronous)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None
