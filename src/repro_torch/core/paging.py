"""Transfer planning (``repro/core/paging.py``): how a queue of pending
transfers is sliced over the rotation groups.  The rest of the JAX module
(packed weight pages, expert manifests) belongs to the expert-paged slice."""
from __future__ import annotations

from typing import List


def transfer_plan(pages_per_layer: int, n_ubs: int) -> List[List[int]]:
    """Split a layer's pages into n_ubs groups; group j is transferred
    while micro-batch j computes (CGOPipe interleaving: the small, urgent
    hidden-state transfer for ub j+1 slots between groups)."""
    groups: List[List[int]] = [[] for _ in range(n_ubs)]
    for p in range(pages_per_layer):
        groups[p * n_ubs // pages_per_layer].append(p)
    return groups
