"""Exact per-step op census of the PyTorch port (``repro/core/census.py``):
FLOPs, HBM bytes and collective bytes for one (architecture x shape x
sharding plan) cell, the same arithmetic on the port's configs and
``distributed.sharding.Plan``.

It is the model the roofline terms come from, as in the paper's
performance model ("theoretically calculated computation flops and bytes
with profiled peak performance and memory bandwidth", §4.2): the port's
layers run as a Python loop, so no compiled program counts them.

Conventions:
  * FLOPs: 2·M·N·K per matmul.
  * HBM bytes (per chip): every weight shard read once per step (3× for
    training: fwd, bwd-wrt-act, bwd-wrt-weight each re-read), KV bytes
    read once per decode step, activations charged ACT_RT round-trips of
    (B,S,D) per layer.
  * Collective bytes (per chip): ring all-reduce of N bytes ≈ 2N wire
    bytes; all-gather/reduce-scatter ≈ N; all-to-all ≈ N.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.base import (ATTN_MLA, ATTN_NONE, ATTN_WINDOW,
                                      ModelConfig, ShapeConfig)
from repro_torch.models.params import count_params

ACT_RT = 6          # activation (B,S,D)-equivalents touched per layer
TRAIN_FLOP_MULT = 3   # bwd = 2x fwd
TRAIN_BYTE_MULT = 3


@dataclass
class Census:
    flops: float = 0.0            # total, whole step, all chips
    hbm_bytes: float = 0.0        # per chip
    coll_bytes: Dict[str, float] = field(default_factory=dict)  # per chip

    def add_coll(self, kind: str, nbytes: float):
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + nbytes

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())


def _axsize(mesh_shape: Dict[str, int], axes) -> int:
    if not axes:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh_shape.get(a, 1)
    return n


def census(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: Dict[str, int],
           plan=None, dtype_bytes: int = 2) -> Census:
    """plan: distributed.sharding.Plan (for dp/kv/expert axes); falls back
    to sensible defaults when None."""
    c = Census()
    chips = math.prod(mesh_shape.values())
    dp_axes = (plan.dp_axes if plan is not None else
               tuple(a for a in ("pod", "data") if a in mesh_shape))
    dp = _axsize(mesh_shape, dp_axes)
    tp = mesh_shape.get("model", 1)

    B, S = shape.global_batch, shape.seq_len
    train = shape.mode == "train"
    decode = shape.mode == "decode"
    tokens = B * (1 if decode else S)
    B_loc = B / dp
    tok_loc = tokens / dp

    E, Dh = cfg.d_model, cfg.head_dim or 0
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    fmult = TRAIN_FLOP_MULT if train else 1
    bmult = TRAIN_BYTE_MULT if train else 1
    cmult = 2 if train else 1        # collectives: fwd + bwd mirror
    # stationary 2D-sharded weights at inference: the embed-dim shard also
    # divides per-chip weight traffic (training re-gathers, so full/tp)
    wshard = tp
    if not train and plan is not None:
        wshard = tp * _axsize(mesh_shape, plan.rules.get("embed"))

    # ---------------- embedding + loss head ----------------
    c.flops += 2.0 * tokens * E * cfg.vocab_size * fmult   # unembed (+loss)
    if train:
        c.flops += 0  # embed gather is bytes, not flops
    # embedding table + head weights read once (sharded over vocab/model)
    c.hbm_bytes += (cfg.vocab_size * E * dtype_bytes / tp) * bmult * \
        (1 if cfg.tie_embeddings else 2)
    if tp > 1:
        # vocab-sharded logits: psum/all-gather of (tok, V/tp) partials is
        # avoided by sharded loss; we charge the label psum only (small).
        c.add_coll("all-reduce", 2 * tok_loc * 4)

    # ---------------- per-layer census ----------------
    specs = list(cfg.prologue) + [s for _ in range(cfg.num_periods)
                                  for s in cfg.period]
    expert_ax = _axsize(mesh_shape, plan.expert_axes) if (
        plan and plan.expert_axes) else 1
    kv_ax = _axsize(mesh_shape, plan.kv_axes) if (plan and plan.kv_axes) else 1

    for spec in specs:
        # ---- attention / mamba mixer ----
        if spec.kind == "attn" and spec.attn != ATTN_NONE:
            if spec.attn == ATTN_MLA:
                r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
                dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
                w_attn = (E * cfg.q_lora_rank + cfg.q_lora_rank * nq * (dn + dr)
                          + E * r + E * dr + r * nq * dn + r * nq * dv
                          + nq * dv * E)
                kv_row = (r + dr)
                if decode:
                    # absorbed decode: q @ Wuk (per head) + latent attention
                    c.flops += 2.0 * B * nq * (r * dn + dv * r) \
                        + 4.0 * B * nq * S * (r + dr)
                else:
                    ctx = S
                    c.flops += (2.0 * tokens * w_attn
                                + 2.0 * tokens * nq * (dn + dr) * ctx / 2 * 2
                                ) * fmult
            else:
                w_attn = E * nq * Dh + 2 * E * nkv * Dh + nq * Dh * E
                kv_row = 2 * nkv * Dh * dtype_bytes
                if getattr(cfg, "kv_dtype", "") == "int8":
                    kv_row = 2 * nkv * (Dh + 4)      # int8 + f32 scale
                kv_row /= dtype_bytes                # normalized below
                win = cfg.window_size if spec.attn == ATTN_WINDOW else 0
                if decode:
                    ctx = min(win, S) if win else S
                    c.flops += 2.0 * B * w_attn + 4.0 * B * nq * Dh * ctx
                else:
                    ctx = min(win, S) if win else S / 2   # causal avg
                    c.flops += (2.0 * tokens * w_attn
                                + 4.0 * tokens * nq * Dh * ctx) * fmult
            c.hbm_bytes += w_attn * dtype_bytes / wshard * bmult
            if decode:
                # KV read: rows sharded over dp x kv_ax
                c.hbm_bytes += B_loc * S * kv_row * dtype_bytes / kv_ax
                # seq-sharded attention: broadcast q + lse psum of o
                if kv_ax > 1:
                    qo = B_loc * nq * (Dh if spec.attn != ATTN_MLA
                                       else cfg.kv_lora_rank) * 4
                    c.add_coll("all-reduce", 2 * 2 * qo)
            else:
                c.hbm_bytes += tok_loc * kv_row * dtype_bytes * bmult
        elif spec.kind == "mamba":
            d_in = cfg.ssm_expand * E
            nh = d_in // cfg.ssm_head_dim
            N = cfg.ssm_state
            w_m = 2 * E * d_in + 2 * E * N + E * nh + d_in * E
            if decode:
                c.flops += 2.0 * B * w_m + 2.0 * B * d_in * N * 2
            else:
                # SSD chunked: intra-chunk (L) + inter-chunk state
                L = cfg.ssm_chunk
                c.flops += (2.0 * tokens * w_m
                            + 2.0 * tokens * L / 2 * (nh + N)     # CB/decay
                            + 4.0 * tokens * N * d_in) * fmult
            c.hbm_bytes += w_m * dtype_bytes / wshard * bmult
            c.hbm_bytes += (B_loc * nh * cfg.ssm_head_dim * N * 4 / tp
                            if decode else 0)

        # ---- FFN ----
        if spec.ffn:
            if spec.moe:
                F = cfg.d_ff
                k_eff = cfg.top_k + cfg.num_shared_experts
                cf = cfg.capacity_factor if train else 1.0
                c.flops += 2.0 * 3 * tokens * E * F * (cfg.top_k * cf
                                                       + cfg.num_shared_experts) * fmult
                c.flops += 2.0 * tokens * E * cfg.num_experts * fmult  # router
                # expert weights per chip (int8 experts halve the traffic)
                ebytes = 1 if getattr(cfg, "expert_dtype", "") == "int8" \
                    else dtype_bytes
                w_exp = cfg.num_experts * 3 * E * F * ebytes / expert_ax
                ffn_shard = _axsize(mesh_shape,
                                    plan.rules.get("effn") if plan else None)
                c.hbm_bytes += w_exp / ffn_shard * bmult
                if cfg.num_shared_experts:
                    c.hbm_bytes += 3 * E * F * cfg.num_shared_experts * \
                        dtype_bytes / wshard * bmult
                # dispatch collectives
                if plan and plan.moe_variant == "ep_a2a":
                    # tokens are sharded over dp ∪ expert_axes for the a2a
                    shard_axes = set(dp_axes) | set(plan.expert_axes)
                    tok_a2a = tokens / _axsize(mesh_shape, tuple(shard_axes))
                    c.add_coll("all-to-all",
                               2 * tok_a2a * E * dtype_bytes
                               * cfg.top_k * cf * cmult)
                elif plan and plan.moe_variant == "ep_psum":
                    c.add_coll("all-reduce",
                               2 * tok_loc * E * dtype_bytes * cmult)
                elif expert_ax > 1:   # grouped_pjit: partitioner moves acts
                    shard_axes = set(dp_axes) | set(plan.expert_axes
                                                    if plan else ())
                    tok_a2a = tokens / _axsize(mesh_shape, tuple(shard_axes))
                    c.add_coll("all-to-all",
                               2 * tok_a2a * E * dtype_bytes
                               * cfg.top_k * cf * cmult)
                elif plan and plan.rules.get("effn") == "model" and tp > 1:
                    # ffn-dim-sharded experts (mixtral on a 16-wide axis):
                    # TP-style activation all-reduce per layer
                    c.add_coll("all-reduce",
                               2 * 2 * tok_loc * E * dtype_bytes * cmult)
            else:
                F = cfg.dense_d_ff or cfg.d_ff
                c.flops += 2.0 * 3 * tokens * E * F * fmult
                c.hbm_bytes += 3 * E * F * dtype_bytes / wshard * bmult
                if tp > 1:
                    # TP FFN+attn output psums (2 per layer, ring 2N)
                    c.add_coll("all-reduce",
                               2 * 2 * tok_loc * E * dtype_bytes * cmult)
        # activations
        c.hbm_bytes += ACT_RT * tok_loc * E * dtype_bytes * bmult

    # ---------------- FSDP weight all-gathers (training) ----------------
    # Only NON-expert params are FSDP-gathered: expert weights are consumed
    # inside the expert-parallel bodies with their native ('data','model')/EP sharding and
    # are never materialized unsharded.
    n_expert = 0
    if cfg.is_moe:
        n_moe_layers = sum(1 for s in specs if s.moe)
        n_expert = (cfg.num_experts * 3 * E * cfg.d_ff * n_moe_layers)
    n_dense = count_params(cfg) - n_expert
    if plan and plan.rules.get("embed") == "data" and train:
        shard = n_dense * dtype_bytes / chips
        # all-gather fwd + bwd, reduce-scatter grads (per-chip wire bytes)
        c.add_coll("all-gather", 2 * shard * (dp - 1))
        c.add_coll("reduce-scatter", shard * (dp - 1))
    if train and mesh_shape.get("pod", 1) > 1:
        # cross-pod gradient all-reduce over DCN (per-chip f32 grads);
        # int8 error-feedback compression (distributed.compression) cuts
        # this 4x when enabled
        grad_bytes = count_params(cfg) * 4 / (chips / mesh_shape["pod"])
        c.add_coll("all-reduce(pod)", 2 * grad_bytes)

    # optimizer traffic (training): read p, mu, nu; write p, mu, nu
    if train:
        per_chip_params = count_params(cfg) / chips
        c.hbm_bytes += per_chip_params * (2 + 4 + 4) * 2

    return c
