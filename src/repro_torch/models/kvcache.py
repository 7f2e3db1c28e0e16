"""KV cache of the PyTorch port: the dense ring part of
``repro/models/kvcache.py``.

A cache is a plain nested dict with the JAX package's layout:

  cache = {
    "pos":  (B,) int32 — current sequence length per row,
    "p{i}": per period position, stacked over its layers, one of
        kv:  {"k": (L,B,W,Hkv,Dh), "v": ..., "slot_pos": (L,B,W) int32}
        mla: {"ckv": (L,B,W,kv_lora), "kr": (L,B,W,rope), "slot_pos": ...}
        ssm: {"conv_x": (L,B,cw-1,d_in), "conv_B" / "conv_C":
              (L,B,cw-1,N), "state": (L,B,nh,hd,N) f32}
    "prologue": the same for the non-periodic leading layers (stacked
        over them), when the architecture has any
    "xattn": {"k": (L,B,encS,Hkv,Dh), "v": ...}  (whisper: the decoder
        layers' cross-attention K and V of the encoder's output, written
        once by prefill and read by every decode step)
  }

W is the ring width: ``min(window, max_seq)`` for sliding-window layers,
``max_seq`` otherwise.  ``slot_pos`` holds the absolute position stored in
each ring slot (-1 = empty), which makes masking exact for full and windowed
layers alike.  An MLA layer caches one compressed latent ``ckv`` and one
rope key ``kr`` per token, shared by every head.

Unlike the JAX package, whose arrays are immutable, the writes and slot
operations here update the cache tensors in place (and return the cache for
symmetry): the pool is allocated once and each decode step touches one slot
per row, so copying it per step would waste memory and bandwidth.

Block-granular paged pool (the ``r_c`` execution path): full-attention kv
and mla period positions can swap their per-slot dense rings for one shared
**arena** of fixed-size token blocks plus a
``(slot, logical_block) → physical_block`` page table
(``init_paged_arena`` / ``paged_view`` / ``write_decode_paged``; the slot
ops below are paged-aware).  A paged layer cache is recognized by its
``page_table`` leaf.  The arena's last physical block is the **trash
block**: the scatter target for rows/positions with no mapped block — its
contents are never read.  The prologue's rings stay dense.

int8 KV (``cfg.kv_dtype == "int8"``): a kv ring or arena holds int8 ``k`` /
``v`` and one f32 scale per (token, head) in ``k_scale`` / ``v_scale``
((L,B,W,Hkv) in a ring, (L,Hkv,NB+1,bt) in an arena), written by
``quantize_kv``; the decode kernels fold the scales into their tiles, so
no dequantized ring exists.

An SSM layer (a Mamba-2 mixer) caches the last ``cw-1`` inputs of its
three depthwise convs and its f32 state, one of each a row; it has no ring
and no ``slot_pos``, stays dense beside a paged arena, and the slot
operations below copy or clear it with the rest of a row.
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


def _spec_cache(cfg: ModelConfig, spec: LayerSpec, stack: int, batch: int,
                max_seq: int, dtype, device: torch.device) -> Dict:
    """The empty ring (or SSM state) of one period position (or of the
    prologue), stacked over its `stack` layers."""
    kind = spec.cache_kind()
    if kind == "ssm":
        # the conv tails in the model dtype and the SSM state in f32; no
        # ring, so no slot_pos
        d_in = cfg.ssm_expand * cfg.d_model
        cw, N = cfg.ssm_conv_width - 1, cfg.ssm_state
        shapes = {"conv_x": ((cw, d_in), dtype),
                  "conv_B": ((cw, N), dtype), "conv_C": ((cw, N), dtype),
                  "state": ((d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, N),
                            torch.float32)}
        return {name: torch.zeros((stack, batch) + tail, dtype=dt,
                                  device=device)
                for name, (tail, dt) in shapes.items()}
    W = layer_cache_width(cfg, spec, max_seq)
    if kind == "mla":
        data = {"ckv": (cfg.kv_lora_rank,), "kr": (cfg.qk_rope_head_dim,)}
    elif kind == "kv":
        data = {name: (cfg.num_kv_heads, cfg.head_dim) for name in ("k", "v")}
    else:
        raise NotImplementedError(f"{kind} caches are not ported yet")
    dtypes = dict.fromkeys(data, dtype)
    if kind == "kv" and cfg.kv_dtype == "int8":
        # int8 values and one f32 dequant scale per (token, head)
        dtypes = {"k": torch.int8, "v": torch.int8,
                  "k_scale": torch.float32, "v_scale": torch.float32}
        data.update(k_scale=(cfg.num_kv_heads,), v_scale=(cfg.num_kv_heads,))
    out = {name: torch.zeros((stack, batch, W) + tail, dtype=dtypes[name],
                             device=device)
           for name, tail in data.items()}
    out["slot_pos"] = torch.full((stack, batch, W), -1, dtype=torch.int32,
                                 device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
               skip_keys=(), device: DeviceLike = None) -> Dict:
    """An empty cache of `batch` rows (slot_pos = -1, pos = 0).
    `skip_keys` omits those period positions (the paged-pool engine
    allocates them as a shared block arena instead of per-slot rings)."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    cache: Dict = {"pos": torch.zeros((batch,), dtype=torch.int32,
                                      device=device)}
    for i, spec in enumerate(cfg.period):
        if f"p{i}" not in skip_keys:
            cache[f"p{i}"] = _spec_cache(cfg, spec, cfg.num_periods, batch,
                                         max_seq, dtype, device)
    if cfg.prologue:
        cache["prologue"] = _spec_cache(cfg, cfg.prologue[0],
                                        len(cfg.prologue), batch, max_seq,
                                        dtype, device)
    if cfg.encoder_layers:
        shape = (cfg.num_periods, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["xattn"] = {name: torch.zeros(shape, dtype=dtype,
                                            device=device)
                          for name in ("k", "v")}
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=None) -> Dict:
    """``init_cache``'s layout as tensors on the ``meta`` device (shapes
    and dtypes, no storage)."""
    return init_cache(cfg, batch, max_seq, dtype, device="meta")


# ---------------------------------------------------------------------------
# Block-granular paged KV pool.  One shared arena of fixed-size token
# blocks replaces the per-slot dense rings of the pageable period
# positions; a (slot, logical_block) -> physical_block page table (managed
# host-side by core.blockpool, uploaded per dispatch) maps each slot's
# logical ring onto arena blocks.  Decode attention reads the arena
# straight through the page table (kernels.ops.paged_gqa_decode_fused
# and kernels.ops.paged_mla_decode_fused); `paged_view` gathers the dense
# ring view their plain versions run on.
#
# Arena layout, head-major with the block axis inside the head axis:
#
#   k / v              (Hkv, NB+1, bt, D)  [stacked: (L, Hkv, NB+1, bt, D)]
#   k_scale / v_scale  (Hkv, NB+1, bt)     (int8 KV only)
#   slot_pos           (NB+1, bt)          [stacked: (L, NB+1, bt)]
#   ckv / kr   (NB+1, bt, lat|dr)     (MLA latents have no head axis)
#
# so one (head, block) tile is a contiguous (bt, D) slab at every bt, and
# one MLA block is a contiguous (bt, lat) latent slab.
# ---------------------------------------------------------------------------

_HEAD_MAJOR = ("k", "v", "k_scale", "v_scale")


def arena_block_axis(name: str, *, stacked: bool = False) -> int:
    """Physical-block axis of an arena leaf (``stacked`` adds the leading
    layer-stack axis the engine's shared arena carries)."""
    ax = 1 if name in _HEAD_MAJOR else 0
    return ax + 1 if stacked else ax


def retile_arena_leaf(name: str, a, *, stacked: bool = False):
    """Token-major block layout (…, NB, bt, Hkv, D) → the head-major arena
    layout above (a view).  Identity for leaves without a head axis."""
    if name not in _HEAD_MAJOR:
        return a
    off = 1 if stacked else 0
    return torch.movedim(a, off + 2, off)


def untile_arena_leaf(name: str, a, *, stacked: bool = False):
    """Inverse of ``retile_arena_leaf`` (head-major → token-major)."""
    if name not in _HEAD_MAJOR:
        return a
    off = 1 if stacked else 0
    return torch.movedim(a, off, off + 2)


def _to_arena_tile(name, blk):
    """Dense-ring block tiles (…, bt, Hkv[, D]) → arena tiles
    (…, Hkv, bt[, D]) for head-major leaves (identity otherwise); the
    scale planes have no D axis."""
    if name not in _HEAD_MAJOR:
        return blk
    ax = -3 if name in ("k", "v") else -2
    return torch.swapaxes(blk, ax, ax + 1)


def paged_period_keys(cfg: ModelConfig) -> tuple:
    """Period positions whose KV ring is block-pageable: full-attention kv
    and mla layers.  Sliding-window rings are exempt (the ring already
    bounds their footprint at `window`); SSM states (one a row, no ring)
    and prologue layers stay dense."""
    return tuple(f"p{i}" for i, spec in enumerate(cfg.period)
                 if spec.cache_kind() in ("kv", "mla")
                 and spec.attn != ATTN_WINDOW)


def init_paged_arena(cfg: ModelConfig, device_blocks: int,
                     block_tokens: int, dtype=None, *,
                     device: DeviceLike = None) -> Dict:
    """Shared physical-block arena for the pageable period positions: each
    per-slot ring (B, W, ...) of the dense layer cache replaced by
    (device_blocks + 1) blocks of `block_tokens` ring slots, in the
    head-major layout above.  Block index `device_blocks` is the trash
    block."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    arena = {}
    for key in paged_period_keys(cfg):
        dense = _spec_cache(cfg, cfg.period[int(key[1:])], cfg.num_periods,
                            device_blocks + 1, block_tokens, dtype, device)
        arena[key] = {name: retile_arena_leaf(name, a, stacked=True)
                      .contiguous() for name, a in dense.items()}
    return arena


def is_paged(layer_cache: Dict) -> bool:
    return "page_table" in layer_cache


def paged_view(layer_cache: Dict) -> Dict:
    """Gather a dense (B, W, ...) ring view of a paged layer cache slice
    (head-major arena leaves plus ``page_table`` (B, MB)), W = MB * bt.
    Logical block lb covers ring positions [lb*bt, (lb+1)*bt), exactly
    the dense ring's layout; unmapped blocks read the trash block but
    their slot_pos is forced to -1, so they are invisible to the validity
    masks.  The plain version of the paged decode kernel runs on it."""
    pt = layer_cache["page_table"]                     # (B, MB)
    B, MB = pt.shape
    trash = layer_cache["slot_pos"].shape[0] - 1
    bt = layer_cache["slot_pos"].shape[1]
    mapped = pt >= 0
    idx = torch.where(mapped, pt, trash).reshape(-1).long()
    out = {}
    for name, a in layer_cache.items():
        if name == "page_table":
            continue
        ax = arena_block_axis(name)
        g = a.index_select(ax, idx)
        if ax:       # head-major: (Hkv, B·MB, bt, D) → (B·MB, bt, Hkv, D)
            g = torch.movedim(g, 0, 2)
        g = g.reshape((B, MB) + tuple(g.shape[1:]))
        if name == "slot_pos":
            g = torch.where(mapped[:, :, None], g, -1)
        out[name] = g.reshape((B, MB * bt) + tuple(g.shape[3:]))
    return out


def decode_scatter_target(layer_cache: Dict, pos):
    """The one-token decode scatter's coordinates: (pb, off) — each row's
    physical block (trash where unmapped) and in-block offset for ring
    position ``pos % W``."""
    pt = layer_cache["page_table"]                     # (B, MB)
    MB = pt.shape[1]
    trash = layer_cache["slot_pos"].shape[0] - 1
    bt = layer_cache["slot_pos"].shape[1]
    i = (pos % (MB * bt)).long()                       # (B,) ring index
    pb = torch.gather(pt, 1, (i // bt)[:, None])[:, 0]
    return torch.where(pb >= 0, pb, trash).long(), i % bt


def _decode_scatter(layer_cache: Dict, new: Dict, pos) -> Dict:
    """Write one token per row (new[name]: (B, 1, Hkv, D), or (B, 1, lat)
    for an MLA latent) into the arena
    block its page table maps for ring position pos % W, in place; rows
    with no mapped block there write the trash block."""
    pb, off = decode_scatter_target(layer_cache, pos)
    for name, val in new.items():
        buf = layer_cache[name]
        tok = val[:, 0].to(buf.dtype)              # (B, Hkv, D) | (B, lat)
        if name in _HEAD_MAJOR:
            buf[:, pb, off] = torch.movedim(tok, 0, 1)
        else:
            buf[pb, off] = tok
    layer_cache["slot_pos"][pb, off] = pos.to(torch.int32)
    return layer_cache


def write_decode_paged(layer_cache: Dict, new: Dict, pos) -> Dict:
    """Paged analogue of `write_decode`.  The decode path does not call
    it: ``kernels.ops.paged_gqa_decode_fused`` / ``paged_mla_decode_fused``
    attend over the fresh token and perform the same scatter in one step."""
    return _decode_scatter(layer_cache, new, pos)


# ---------------------------------------------------------------------------
# Slot-pool operations.  A cache allocated once with batch = number of slots
# is a pool of independent per-row slots: a finished row is reset and
# refilled with a new request without touching its neighbours (continuous
# batching).  Batch is axis 0 for "pos" and axis 1 (after the layer-stack
# axis) for every other leaf.
# ---------------------------------------------------------------------------

def reset_slot(cache: Dict, row) -> Dict:
    """Restore batch row `row` (an index, or a slice of rows) to its
    init_cache state (slot_pos = -1, pos = 0, zeros elsewhere), in place;
    other rows are untouched.  Paged groups are left alone: a freed slot
    maps no arena blocks, and fresh allocations clear their slot_pos plane
    at map time."""
    for k, v in cache.items():
        if k == "pos":
            v[row] = 0
        elif not is_paged(v):
            for name, a in v.items():
                a[:, row] = -1 if name == "slot_pos" else 0
    return cache


def _insert_row_blocks(group: Dict, single_group: Dict, row: int,
                       src: int) -> None:
    """Copy a dense ring row of `single_group` into the arena blocks the
    page table maps for slot `row` (the trash block where unmapped —
    content discarded, as the dense ring's unwritten slot_pos=-1 span)."""
    pt = group["page_table"][0, row]                   # (MB,) layer-invariant
    MB = pt.shape[0]
    trash = group["slot_pos"].shape[1] - 1
    bt = group["slot_pos"].shape[2]
    pb = torch.where(pt >= 0, pt, trash).long()
    for name, a in group.items():
        if name == "page_table":
            continue
        blk = single_group[name][:, src]               # (L, W[, Hkv, D])
        blk = blk.reshape((blk.shape[0], MB, bt) + tuple(blk.shape[2:]))
        tile = _to_arena_tile(name, blk.to(a.dtype))   # (L, MB[, Hkv], bt..)
        if name in _HEAD_MAJOR:
            a[:, :, pb] = torch.movedim(tile, 1, 2)
        else:
            a[:, pb] = tile


def insert_slot(cache: Dict, single: Dict, row: int, src: int = 0) -> Dict:
    """Slot-indexed prefill write: copy batch row `src` of `single` (a dense
    cache freshly prefilled for one request) into batch row `row` of the
    pooled `cache`, in place.  Only that row changes.  Paged groups
    scatter the dense ring into the slot's mapped arena blocks (the block
    pool must have mapped blocks covering the row's footprint first)."""
    for k, v in cache.items():
        if k == "pos":
            v[row] = single[k][src]
        elif is_paged(v):
            _insert_row_blocks(v, single[k], row, src)
        else:
            for name, a in v.items():
                a[:, row] = single[k][name][:, src].to(a.dtype)
    return cache


def insert_slot_span(cache: Dict, single: Dict, row: int, start: int, *,
                     length: int) -> Dict:
    """Partial slot insert at a row offset: copy only the ring slots holding
    absolute positions [start, start + length) of batch row 0 of `single`
    into batch row `row` of the pooled `cache` (plus `single`'s row-0 pos),
    in place.  The chunked-prefill admission path: each staged chunk lands
    in the pool as soon as it is computed.  Ring indices are taken modulo
    each leaf's own ring width.  Unlike `insert_slot`, a span does not
    clear the rest of the row: callers `reset_slot` the row once before a
    new request's first span.  Paged groups copy the whole arena blocks
    the span overlaps (the scratch ring holds the slot's entire prefix, so
    re-copying a block's part before the span rewrites the same values);
    the overlapped blocks must be mapped, else they land in the trash
    block."""
    for k, v in cache.items():
        if k == "pos":
            v[row] = single[k][0]
        elif is_paged(v):
            _insert_span_blocks(v, single[k], row, start, length)
        else:
            for name, a in v.items():
                idx = (torch.arange(start, start + length, device=a.device)
                       % a.shape[2])
                a[:, row, idx] = single[k][name][:, 0, idx].to(a.dtype)
    return cache


def _insert_span_blocks(group: Dict, single_group: Dict, row: int,
                        start: int, length: int) -> None:
    """The paged branch of `insert_slot_span`: the logical blocks the span
    [start, start + length) overlaps, in unwrapped coordinates taken modulo
    the slot's MB blocks (the dense branch's ring wrap), each copied from
    the scratch ring into the physical block the page table maps."""
    pt = group["page_table"][0, row]                   # (MB,) layer-invariant
    MB = pt.shape[0]
    trash = group["slot_pos"].shape[1] - 1
    bt = group["slot_pos"].shape[2]
    first = start // bt
    # the MB cap keeps the targets unique, as in the reference
    lbs = [(first + j) % MB for j in range(min(length // bt + 2, MB))
           if (first + j) * bt < start + length]
    idx = torch.tensor(lbs, dtype=torch.long, device=pt.device)
    pb = torch.where(pt[idx] >= 0, pt[idx], trash).long()
    for name, a in group.items():
        if name == "page_table":
            continue
        blk = single_group[name][:, 0]                 # (L, W[, Hkv, D])
        blk = blk.reshape((blk.shape[0], MB, bt) + tuple(blk.shape[2:]))
        tile = _to_arena_tile(name, blk[:, idx].to(a.dtype))
        if name in _HEAD_MAJOR:
            a[:, :, pb] = torch.movedim(tile, 1, 2)
        else:
            a[:, pb] = tile


# ---------------------------------------------------------------------------
# Window composition (module-based batching).  The engine allocates the
# rotation groups' slot caches as one pool cache of num_ubs·ubatch rows,
# group-major, and gives each group its rows as views: a window of
# consecutive groups is then a view too, dispatched as one (G·B)-row decode
# chunk that writes the groups' rows in place.  Batch is axis 0 for "pos"
# and axis 1 for every other leaf.  Arena leaves have no batch axis and
# never pass through these: the engine composes the arena with a
# window-wide page table per dispatch.
# ---------------------------------------------------------------------------

def slot_rows(cache: Dict, start: int, n: int) -> Dict:
    """Batch rows [start, start + n) of a slot cache, as views."""
    return {k: (slot_rows(v, start, n) if isinstance(v, dict)
                else v.narrow(0 if k == "pos" else 1, start, n))
            for k, v in cache.items()}


def concat_slot_caches(caches):
    """One window cache of several groups' slot caches, group-major (a
    copy; the static engine's windows, whose micro-batches need not hold
    consecutive rows of the pool)."""
    return {k: (concat_slot_caches([c[k] for c in caches])
                if isinstance(v, dict)
                else torch.cat([c[k] for c in caches], 0 if k == "pos" else 1))
            for k, v in caches[0].items()}


def split_slot_cache(cache: Dict, n: int):
    """`n` equal per-group slot caches of a (group-major) window or pool
    cache, views into it."""
    b = cache["pos"].shape[0] // n
    return [slot_rows(cache, i * b, b) for i in range(n)]


# ---------------------------------------------------------------------------
# int8 KV: per-(token, head) symmetric quantization.
# ---------------------------------------------------------------------------

def quantize_kv(k, v) -> Dict:
    """k/v: (B, S, Hkv, D) -> int8 values and f32 scales (B, S, Hkv).
    Rounds half to even, as ``jnp.round`` does, so values and scales are
    the JAX package's bit for bit."""
    def q(x):
        xf = x.float()
        scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
        qx = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return qx.to(torch.int8), scale
    qk, sk = q(k)
    qv, sv = q(v)
    return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}


def dequantize_kv(layer_cache: Dict):
    """(k, v) in f32 from an int8 layer cache or ring view: the plain
    version's check value, never the served path (the kernels and the
    chunk attention fold the scales into their tiles)."""
    k = layer_cache["k"].float() * layer_cache["k_scale"][..., None]
    v = layer_cache["v"].float() * layer_cache["v_scale"][..., None]
    return k, v


# ---------------------------------------------------------------------------
# Ring-buffer writes.  They operate on a single layer slice (no leading
# stack dim), a view into the stacked cache, so the writes land in the pool.
# ---------------------------------------------------------------------------

def write_prefill(layer_cache: Dict, new: Dict, seq_positions,
                  ring=None) -> Dict:
    """Write a full prefill chunk.  new[name]: (B, S, ...); seq_positions:
    (S,) absolute positions being written.  If S exceeds the ring width W
    (sliding-window layer), only the last W positions are kept.

    ring: (first slot, whole width) when this cache holds one rank's block
    of a ring sharded over the KV axes (``tensor_parallel.ShardCtx.ring``):
    only the positions whose slot falls in the block are written."""
    W_loc = layer_cache["slot_pos"].shape[-1]
    lo, W = ring if ring is not None else (0, W_loc)
    S = seq_positions.shape[0]
    if S > W:
        new = {k: v[:, -W:] for k, v in new.items()}
        seq_positions = seq_positions[-W:]
    slots = (seq_positions % W).long() - lo
    if ring is not None:
        mine = torch.nonzero((slots >= 0) & (slots < W_loc))[:, 0]
        new = {k: v[:, mine] for k, v in new.items()}
        slots, seq_positions = slots[mine], seq_positions[mine]
    for name, val in new.items():
        buf = layer_cache[name]
        buf[:, slots] = val.to(buf.dtype)
    layer_cache["slot_pos"][:, slots] = seq_positions.to(torch.int32)[None, :]
    return layer_cache


def write_decode(layer_cache: Dict, new: Dict, pos, ring=None) -> Dict:
    """Write one token per row.  new[name]: (B, 1, ...); pos: (B,).
    ring: as ``write_prefill``'s; a row whose slot ``pos % W`` lies in
    another rank's block keeps this block as it is."""
    W_loc = layer_cache["slot_pos"].shape[-1]
    if ring is None:
        slots, mine = (pos % W_loc).long(), None
    else:
        lo, W = ring
        slots = (pos % W).long() - lo
        mine = (slots >= 0) & (slots < W_loc)
        slots = torch.clamp(slots, 0, W_loc - 1)
    brow = torch.arange(slots.shape[0], device=slots.device)

    def put(buf, val):
        val = val.to(buf.dtype)
        if mine is not None:
            m = mine.reshape((-1,) + (1,) * (val.dim() - 1))
            val = torch.where(m, val, buf[brow, slots])
        buf[brow, slots] = val

    for name, val in new.items():
        put(layer_cache[name], val[:, 0])
    put(layer_cache["slot_pos"], pos.to(torch.int32))
    return layer_cache
