"""Data pipeline (``repro/data/pipeline.py``): deterministic synthetic
corpus → document packing → per-host sharding → background prefetch, with
the reference's numpy streams (the same seed gives the same tokens).

Two deliberate changes, so that the stream is the same however it is
read:
- The producer thread starts at the first ``next()``, not in the
  constructor.  The reference starts it at once, so the ``skip(n)`` a
  resumed trainer calls advances the same generator the producer is
  already drawing from: the resumed stream is not the uninterrupted one
  (and the two threads can raise "generator already executing").  Here
  ``skip`` runs before the producer exists, and raises once it does.
- A batch, once built, is offered to the queue until it is taken.  The
  reference's producer drops the batch it built when the queue stays full
  for its 0.5 s put timeout, so a step slower than that loses a batch and
  the stream depends on the step time.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int                  # per-host
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    eos_id: int = 1
    mean_doc_len: int = 256
    zipf_a: float = 1.3


class SyntheticCorpus:
    """Deterministic stream of EOS-terminated documents."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # distinct stream per (seed, host): PCG64 jumped by host index
        seq = np.random.SeedSequence([cfg.seed, cfg.host_id])
        self.rng = np.random.default_rng(seq)

    def documents(self) -> Iterator[np.ndarray]:
        c = self.cfg
        while True:
            n = max(2, int(self.rng.exponential(c.mean_doc_len)))
            toks = self.rng.zipf(c.zipf_a, size=n) % (c.vocab_size - 2) + 2
            yield np.concatenate([toks.astype(np.int32), [c.eos_id]])


def pack_documents(docs: Iterator[np.ndarray], seq_len: int
                   ) -> Iterator[np.ndarray]:
    """Greedy packing of documents into fixed seq_len+1 rows (the +1 makes
    the (inputs, targets) shift trivial)."""
    buf = np.empty(0, np.int32)
    need = seq_len + 1
    for d in docs:
        buf = np.concatenate([buf, d])
        while len(buf) >= need:
            yield buf[:need]
            buf = buf[need:]


class DataPipeline:
    """Batched, prefetching iterator of {"tokens", "targets"} host arrays."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        self.cfg = cfg
        self._rows = pack_documents(SyntheticCorpus(cfg).documents(),
                                    cfg.seq_len)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    def _make_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        rows = np.stack([next(self._rows) for _ in range(c.batch_size)])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "targets": rows[:, 1:].astype(np.int32)}

    def _producer(self):
        while not self._stop.is_set():
            batch = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()
        self._step += 1
        return self._q.get()

    @property
    def step(self) -> int:
        return self._step

    def skip(self, n: int):
        """Fast-forward after checkpoint restore (stream determinism): only
        before the first batch is drawn, while no producer runs."""
        if self._thread is not None:
            raise RuntimeError("skip() after the stream started: the "
                               "producer already draws from it")
        c = self.cfg
        for _ in range(n):
            for _ in range(c.batch_size):
                next(self._rows)
            self._step += 1

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
