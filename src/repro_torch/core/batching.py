"""Request batching (paper Algorithm 2, Appendix A.2): the balance
criterion applied to one request at a time, as the continuous-batching
scheduler admits it, and the block-granular charge of the paged KV pool.
The whole-queue pass of static mode is a later slice."""
from __future__ import annotations

from typing import Optional, Sequence


def place_request(input_len: int, partition_sums: Sequence[int],
                  partition_counts: Sequence[int], *, gen_len: int,
                  cache_size: int,
                  open_mask: Optional[Sequence[bool]] = None,
                  reserve: Optional[int] = None) -> Optional[int]:
    """Incremental single-request placement: Algorithm 2's balance criterion
    applied to ONE request against live partitions (continuous batching).

    partition_sums/partition_counts: current token load and live request
    count per partition; each co-resident reserves `gen_len` generation
    tokens (pass gen_len=0 when partition_sums already include their
    reservations) and the candidate reserves `reserve` (default gen_len —
    the batch-mode uniform bound).  open_mask: which partitions can still
    take a request (e.g. have a free slot).  Returns the index of the
    least-loaded open partition if the projected cache use fits the
    budget, else None (caller defers or aborts the request)."""
    cands = [i for i in range(len(partition_sums))
             if open_mask is None or open_mask[i]]
    if not cands:
        return None
    idx = min(cands, key=lambda i: partition_sums[i])
    projected = (partition_sums[idx] + input_len
                 + (gen_len if reserve is None else reserve)
                 + partition_counts[idx] * gen_len)
    if projected > cache_size:
        return None
    return idx


def blocks_for_tokens(tokens: int, block_tokens: int) -> int:
    """Fixed-size KV blocks covering `tokens` ring positions (ceil; 0 for
    an empty footprint).  The unit of the block-granular paged KV cache's
    admission accounting: a request occupies whole blocks of the shared
    arena, so budget charges round up to the block boundary."""
    if tokens <= 0:
        return 0
    return -(-tokens // block_tokens)


def round_to_blocks(tokens: int, block_tokens: Optional[int]) -> int:
    """Token charge of a footprint under block-granular accounting
    (identity when block_tokens is None — the dense max_seq-wide pool)."""
    if not block_tokens:
        return tokens
    return blocks_for_tokens(tokens, block_tokens) * block_tokens
