"""Request batching (paper Algorithm 2, Appendix A.2).

Balanced token distribution: requests sorted by input length descending,
each placed into the micro-batch with the fewest tokens, subject to a KV
cache budget; full micro-batches are sealed (``batch_requests``, the
static mode's admission).  The same balance criterion applied to one
request at a time is how the continuous-batching scheduler admits
(``place_request``).  Beside them: the block-granular charge of the paged
KV pool, and the running estimate of generation lengths behind EOS-aware
reservations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class GenLenEWMA:
    """Running EWMA of observed generation lengths.

    Feeds the scheduler's EOS-aware reservations: instead of reserving
    each live request's worst-case remaining quota, reserve the *expected*
    remaining length — requests that hit EOS early stop inflating the
    KV budget for everyone behind them.  Until the first observation the
    estimate is None and callers must fall back to the worst case."""

    def __init__(self, alpha: float = 0.25):
        assert 0.0 < alpha <= 1.0
        self.alpha = alpha
        self.value: Optional[float] = None
        self.count = 0

    def observe(self, gen_len: int) -> None:
        self.count += 1
        if self.value is None:
            self.value = float(gen_len)
        else:
            self.value += self.alpha * (gen_len - self.value)

    def expected(self, max_new_tokens: int) -> int:
        """Expected total generation length for a request with the given
        quota (never optimistic below 1, never beyond the quota)."""
        if self.value is None:
            return max_new_tokens
        return max(1, min(max_new_tokens, math.ceil(self.value)))


@dataclass(frozen=True)
class Request:
    rid: int
    input_len: int
    gen_len: int = 0


@dataclass
class MicroBatch:
    requests: List[Request] = field(default_factory=list)

    @property
    def tokens(self) -> int:
        return sum(r.input_len for r in self.requests)

    def __len__(self):
        return len(self.requests)


def batch_requests(req_queue: List[Request], n_ub: int, ubs: int,
                   gen_len: int, cache_size: int
                   ) -> Tuple[List[MicroBatch], List[Request]]:
    """Algorithm 2 verbatim.

    req_queue: queue of requests; n_ub: number of micro-batches;
    ubs: max requests per micro-batch; gen_len: generation length;
    cache_size: max cache tokens per micro-batch.
    Returns (micro_batches, aborted_requests)."""
    partitions: List[MicroBatch] = [MicroBatch() for _ in range(n_ub)]
    partition_sums: List[int] = [0] * n_ub
    micro_batches: List[MicroBatch] = []
    aborted: List[Request] = []

    for req in sorted(req_queue, key=lambda r: r.input_len, reverse=True):
        idx = place_request(req.input_len, partition_sums,
                            [len(p) for p in partitions],
                            gen_len=gen_len, cache_size=cache_size)
        if idx is None:
            aborted.append(req)
            continue
        partitions[idx].requests.append(req)
        partition_sums[idx] += req.input_len
        if len(partitions[idx]) == ubs:
            micro_batches.append(partitions.pop(idx))
            partition_sums.pop(idx)
    # remaining (non-empty, unsealed) partitions are emitted too — they are
    # simply smaller; the engine pads them to the micro-batch size
    for p in partitions:
        if len(p):
            micro_batches.append(p)
    return micro_batches, aborted


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
