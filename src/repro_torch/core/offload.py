"""The pinned host tier (``repro/core/offload.py``'s placement of host-side
stores, for the paged KV pool's spilled blocks).

On the card the store is page-locked host memory, so that spills and
fetches are asynchronous DMA copies on the current stream.  A store that
cannot be pinned raises: it never turns quietly into pageable memory,
whose copies are synchronous and run at a fraction of the link's rate.
Where the engine runs on the CPU (``device="cpu"``) the store is a plain
CPU tensor.
"""
from __future__ import annotations

import torch


def host_store(shape, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    """A zeroed host-side store for an engine on `device`: pinned for a
    CUDA device (raising if the allocation is refused or comes back
    unpinned), plain for the CPU."""
    if device.type == "cpu":
        return torch.zeros(shape, dtype=dtype)
    if device.type != "cuda":
        raise ValueError(f"no host tier for device {device}")
    t = torch.empty(shape, dtype=dtype, pin_memory=True)
    if not t.is_pinned():
        raise RuntimeError(f"host store of {tuple(shape)} {dtype} "
                           "was not pinned")
    return t.zero_()
