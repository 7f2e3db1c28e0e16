"""KV cache of the PyTorch port: the dense ring part of
``repro/models/kvcache.py``.

A cache is a plain nested dict with the JAX package's layout:

  cache = {
    "pos":  (B,) int32 — current sequence length per row,
    "p{i}": per period position, stacked over its layers:
        {"k": (L,B,W,Hkv,Dh), "v": (L,B,W,Hkv,Dh), "slot_pos": (L,B,W) int32}
  }

W is the ring width: ``min(window, max_seq)`` for sliding-window layers,
``max_seq`` otherwise.  ``slot_pos`` holds the absolute position stored in
each ring slot (-1 = empty), which makes masking exact for full and windowed
layers alike.

Unlike the JAX package, whose arrays are immutable, the writes and slot
operations here update the cache tensors in place (and return the cache for
symmetry): the pool is allocated once and each decode step touches one slot
per row, so copying it per step would waste memory and bandwidth.  The
block-paged arena, int8 KV and the SSM / MLA caches are later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ATTN_WINDOW, LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import torch_dtype


def layer_cache_width(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> int:
    if spec.attn == ATTN_WINDOW:
        return min(cfg.window_size, max_seq)
    return max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               device: DeviceLike = None) -> Dict:
    """An empty cache of `batch` rows (slot_pos = -1, pos = 0)."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    if cfg.kv_dtype == "int8":
        raise NotImplementedError("int8 KV is not ported yet")
    if cfg.prologue or cfg.encoder_layers:
        raise NotImplementedError("prologue / encoder caches are not ported")
    cache: Dict = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                      device=device)}
    L = cfg.num_periods
    for i, spec in enumerate(cfg.period):
        if spec.cache_kind() != "kv":
            raise NotImplementedError(
                f"{spec.cache_kind()} caches are not ported yet")
        W = layer_cache_width(cfg, spec, max_seq)
        shape = (L, batch, W, cfg.num_kv_heads, cfg.head_dim)
        cache[f"p{i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((L, batch, W), -1, dtype=torch.int32,
                                   device=device),
        }
    return cache


# ---------------------------------------------------------------------------
# Slot-pool operations.  A cache allocated once with batch = number of slots
# is a pool of independent per-row slots: a finished row is reset and
# refilled with a new request without touching its neighbours (continuous
# batching).  Batch is axis 0 for "pos" and axis 1 (after the layer-stack
# axis) for every other leaf.
# ---------------------------------------------------------------------------

def reset_slot(cache: Dict, row: int) -> Dict:
    """Restore batch row `row` to its init_cache state (slot_pos = -1,
    pos = 0, zeros elsewhere), in place; other rows are untouched."""
    for k, v in cache.items():
        if k == "pos":
            v[row] = 0
        else:
            for name, a in v.items():
                a[:, row] = -1 if name == "slot_pos" else 0
    return cache


def insert_slot(cache: Dict, single: Dict, row: int, src: int = 0) -> Dict:
    """Slot-indexed prefill write: copy batch row `src` of `single` (a dense
    cache freshly prefilled for one request) into batch row `row` of the
    pooled `cache`, in place.  Only that row changes."""
    for k, v in cache.items():
        if k == "pos":
            v[row] = single[k][src]
        else:
            for name, a in v.items():
                a[:, row] = single[k][name][:, src].to(a.dtype)
    return cache


# ---------------------------------------------------------------------------
# Ring-buffer writes.  They operate on a single layer slice (no leading
# stack dim), a view into the stacked cache, so the writes land in the pool.
# ---------------------------------------------------------------------------

def write_prefill(layer_cache: Dict, new: Dict, seq_positions) -> Dict:
    """Write a full prefill chunk.  new[name]: (B, S, ...); seq_positions:
    (S,) absolute positions being written.  If S exceeds the ring width W
    (sliding-window layer), only the last W positions are kept."""
    W = layer_cache["slot_pos"].shape[-1]
    S = seq_positions.shape[0]
    if S > W:
        new = {k: v[:, -W:] for k, v in new.items()}
        seq_positions = seq_positions[-W:]
    slots = (seq_positions % W).long()
    for name, val in new.items():
        buf = layer_cache[name]
        buf[:, slots] = val.to(buf.dtype)
    layer_cache["slot_pos"][:, slots] = seq_positions.to(torch.int32)[None, :]
    return layer_cache


def write_decode(layer_cache: Dict, new: Dict, pos) -> Dict:
    """Write one token per row.  new[name]: (B, 1, ...); pos: (B,)."""
    W = layer_cache["slot_pos"].shape[-1]
    slots = (pos % W).long()
    brow = torch.arange(slots.shape[0], device=slots.device)
    for name, val in new.items():
        buf = layer_cache[name]
        buf[brow, slots] = val[:, 0].to(buf.dtype)
    layer_cache["slot_pos"][brow, slots] = pos.to(torch.int32)
    return layer_cache
