"""Sharding plans of the PyTorch port (``repro/distributed/sharding.py``):
logical-axis rules -> a spec per leaf for each (arch x shape x mesh), and
the wired ``ExecPolicy`` (the MoE path, the sequence-sharded decode
attention, remat).

Axis roles:
  pod    — pure data parallelism across pods; gradients all-reduce.
  data   — FSDP/ZeRO + batch sharding inside a pod (and the major expert
           axis for very large MoEs).
  model  — tensor parallelism (heads / ffn / vocab), expert parallelism,
           and the KV-sequence axis for sharded decode attention.

MoE expert-axis selection (per-chip capacity driven):
  1. experts over ('data','model') when divisible (deepseek-v3: 256/256),
  2. else experts over ('model',) when divisible (moonshot 64, jamba 16),
     plus ffn over 'data' if the per-chip expert slice still exceeds the
     budget (jamba),
  3. else no expert sharding; ffn over 'model' (mixtral's 8 experts on a
     16-wide axis).

A ``Spec`` is the port's ``PartitionSpec``: one entry per dim, each None,
an axis name or a tuple of axis names, trailing Nones dropped.
``shard_tree`` takes this rank's slice of every leaf, the counterpart of
``device_put`` with a ``NamedSharding``.  The plan's policy runs the
expert-parallel MoE bodies and the sequence-sharded attention as local
bodies over the mesh's process groups (``distributed.collectives``).  Over
more than one rank it also holds a ``tensor_parallel.ShardCtx``
(``ExecPolicy.shard``), with which a whole train or decode step runs on
each rank's slices: the heads, ``ffn``, ``vocab`` and ``effn`` splits over
'model', FSDP's ``embed`` over 'data' (XLA's partitioner's work in the
reference).  The Mamba-2 mixer's split, MLA, whisper's encoder, paligemma's
prefix and ``decode_2d`` raise there (``tensor_parallel.check_supported``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import ExecPolicy
from repro_torch.models.params import (count_params, param_axes, param_defs,
                                       tree_map_defs)

EXPERT_BYTES_BUDGET = 8e9        # per-chip expert-slice budget (bf16 bytes)


class Spec(tuple):
    """A partition spec: per dim None, an axis or a tuple of axes.  A
    one-axis tuple is stored as its axis and trailing Nones are dropped,
    so equal shardings compare equal."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = None if not p else (p[0] if len(p) == 1 else p)
            norm.append(p)
        while norm and norm[-1] is None:
            norm.pop()
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


@dataclass
class Plan:
    mesh: Mesh
    rules: Dict[str, object]              # logical axis -> mesh axes
    dp_axes: Tuple[str, ...]              # batch axes
    kv_axes: Tuple[str, ...]              # decode KV sequence axes
    expert_axes: Tuple[str, ...]
    moe_variant: str                      # ep_a2a | ep_psum | grouped_pjit | dense
    param_specs: Dict = None
    policy: ExecPolicy = None


def expert_sharding_for(cfg: ModelConfig, mesh: Mesh
                        ) -> Tuple[Tuple[str, ...], bool]:
    """Returns (expert_axes, shard_ffn_over_data)."""
    if not cfg.is_moe:
        return (), False
    have = mesh.shape
    cands = []
    if "data" in have and "model" in have:
        cands.append(("data", "model"))
    if "model" in have:
        cands.append(("model",))
    expert_bytes = (cfg.num_experts * 3 * cfg.d_model * cfg.d_ff
                    * cfg.num_layers * 2)
    for axes in cands:
        n = _axis_size(mesh, axes)
        if cfg.num_experts % n == 0:
            per_chip = expert_bytes / n
            shard_ffn = per_chip > EXPERT_BYTES_BUDGET and "data" not in axes
            return axes, shard_ffn
    return (), False


def _weights_outgrow_model_axis(cfg: ModelConfig, mesh: Mesh) -> bool:
    """The bf16 weights over the model axis alone exceed 12 GB a chip."""
    return count_params(cfg) * 2 / max(_axis_size(mesh, "model"), 1) > 12e9


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Dict:
    have = set(mesh.axis_names)
    train = shape.mode == "train"
    expert_axes, shard_ffn_data = expert_sharding_for(cfg, mesh)
    model = "model" if "model" in have else None
    rules = {
        "vocab": model, "heads": model, "kv_heads": model,
        "experts": expert_axes or None,
        "lora": None,
        "embed_nr": None,                       # norm scales replicated
        "layers": None, "conv": None,
        "ssm_inner": model, "ssm_heads": model,
        "ffn": model,                           # dense FFNs
    }
    if cfg.is_moe:
        if expert_axes:
            rules["effn"] = ("data" if (shard_ffn_data and "data" in have)
                             else None)
        else:
            rules["effn"] = model
    # FSDP over 'data' for the embed dim in training; decode keeps embed
    # replicated unless the model cannot fit on the model axis alone
    big = _weights_outgrow_model_axis(cfg, mesh)
    rules["embed"] = ("data" if ("data" in have and (train or big)) else None)
    return rules


def spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  rules: Dict, mesh: Mesh) -> Spec:
    """Map a leaf's logical axes to a Spec, enforcing divisibility and
    one-mesh-axis-per-leaf uniqueness."""
    used = set()
    parts = []
    for dim, logical in zip(shape, axes):
        assign = None
        rule = rules.get(logical) if logical else None
        if rule:
            cand = (rule,) if isinstance(rule, str) else tuple(rule)
            cand = tuple(a for a in cand if a not in used)
            if cand and dim % _axis_size(mesh, cand) == 0:
                assign = cand if len(cand) > 1 else cand[0]
                used.update(cand)
        parts.append(assign)
    return Spec(*parts)


def param_specs(cfg: ModelConfig, rules: Dict, mesh: Mesh) -> Dict:
    return tree_map_defs(lambda d: spec_for_axes(d.axes, d.shape, rules,
                                                 mesh), param_defs(cfg))


def cache_specs(cfg: ModelConfig, cache_tree, dp: Tuple[str, ...],
                kv_axes: Tuple[str, ...], rules: Dict, mesh: Mesh) -> Dict:
    """Specs for a dense decode cache tree (``kvcache.init_cache``)."""
    dpa = dp if dp else None
    kva = kv_axes or None

    def model_if_divides(n):
        return ("model" if "model" in mesh.axis_names
                and n % mesh.shape["model"] == 0 else None)

    def leaf_spec(path, leaf):
        name = path[-1]
        if name == "pos":
            return Spec(dpa)
        if name in ("k", "v"):          # (L,B,W,Hkv,Dh)
            if path[0] == "xattn":      # encoder positions: no seq sharding
                return Spec(None, dpa)
            return Spec(None, dpa, kva)
        if name in ("ckv", "kr", "slot_pos"):   # (L,B,W,...)
            return Spec(None, dpa, kva)
        if name == "state":             # (L,B,nh,hd,N)
            return Spec(None, dpa, model_if_divides(leaf.shape[2]))
        if name == "conv_x":            # (L,B,cw-1,d_in)
            return Spec(None, dpa, None, model_if_divides(leaf.shape[3]))
        if name in ("conv_B", "conv_C"):
            return Spec(None, dpa)
        return Spec()

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return leaf_spec(path, tree)

    return walk(cache_tree)


def batch_specs(batch_tree, dp: Tuple[str, ...]) -> Dict:
    """tokens/targets/frames/patches: batch over dp."""
    return {k: Spec(dp if dp else None) for k in batch_tree}


def choose_moe_variant(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                       expert_axes) -> str:
    if not cfg.is_moe:
        return "dense"
    if not expert_axes:
        return "grouped_pjit"
    if shape.mode == "decode":
        # tiny activations: psum combine over 'model' only; with
        # ('data','model') expert sharding the grouped path
        return "ep_psum" if expert_axes == ("model",) else "grouped_pjit"
    # train/prefill: all-to-all when the sequence can shard over the
    # non-data expert axes
    seq_axes = tuple(a for a in expert_axes if a != "data")
    if seq_axes and shape.seq_len % _axis_size(mesh, seq_axes) == 0:
        return "ep_a2a"
    return "grouped_pjit"


def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *,
              use_kernels: bool = False, remat: Optional[bool] = None,
              moe_variant: Optional[str] = None,
              kv_axes: Optional[Tuple[str, ...]] = None,
              decode_2d: bool = False) -> Plan:
    """decode_2d: stationary-weights decode for very large models — the
    batch is replicated (dp=()); 'data' becomes a second weight-sharding
    axis (embed dim / expert-FFN dim), so each decode step sums
    (batch x d_model)-sized activations instead of gathering weight
    shards.  KV pages shard over ('data','model')."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.tensor_parallel import ShardCtx
    have = set(mesh.axis_names)
    dp = tuple(a for a in ("pod", "data") if a in have)
    # batch must divide the dp axes; shrink until it does
    while dp and shape.global_batch % _axis_size(mesh, dp) != 0:
        dp = dp[1:]
    if shape.mode == "decode" and "data" in have and not decode_2d:
        # stationary-weights decode whenever model-axis sharding alone
        # cannot hold the weights, unless the experts already shard over
        # ('data','model') (deepseek-v3)
        e_ax, _ = expert_sharding_for(cfg, mesh)
        if _weights_outgrow_model_axis(cfg, mesh) and e_ax != ("data",
                                                               "model"):
            decode_2d = True
    if decode_2d:
        dp = tuple(a for a in dp if a == "pod")
    if kv_axes is None:
        if shape.mode == "decode":
            spare = tuple(a for a in ("data", "model")
                          if a in have and a not in dp)
            kv_axes = spare if spare else (("model",) if "model" in have
                                           else ())
        else:
            kv_axes = ()
    rules = make_rules(cfg, shape, mesh)
    expert_axes, _ = expert_sharding_for(cfg, mesh)
    if decode_2d and "data" in have:
        rules["embed"] = "data"
        if cfg.is_moe and expert_axes == ("model",):
            rules["effn"] = "data"
    variant = moe_variant or choose_moe_variant(cfg, shape, mesh,
                                                expert_axes)
    if decode_2d and cfg.is_moe and expert_axes == ("model",):
        variant = "ep_psum"

    # wire the execution policy
    moe_fn, moe_impl = None, "dense"
    if cfg.is_moe:
        if variant in ("ep_psum", "ep_a2a"):
            ffn_axes = (("data",) if (rules.get("effn") == "data"
                                      and variant == "ep_psum"
                                      and "data" not in expert_axes
                                      and "data" not in dp) else ())
            moe_fn = C.make_moe_shard_fn(
                mesh, cfg, variant=variant, dp_axes=dp,
                expert_axes=expert_axes, use_kernels=use_kernels,
                ffn_axes=ffn_axes, tp=mesh.size > 1)
        elif variant == "grouped_pjit":
            moe_impl = "grouped"
    attn_fn = None
    if shape.mode == "decode" and kv_axes and not cfg.is_attention_free:
        attn_fn = C.make_seq_sharded_attn(mesh, dp, tuple(kv_axes))

    specs = param_specs(cfg, rules, mesh)
    shard = (ShardCtx(mesh, rules, dp, tuple(kv_axes), expert_axes, specs,
                      param_axes(cfg), decode_2d) if mesh.size > 1 else None)
    policy = ExecPolicy(
        moe_impl=moe_impl, moe_fn=moe_fn, attn_fn=attn_fn,
        use_kernels=use_kernels,
        remat=(shape.mode == "train") if remat is None else remat,
        shard=shard)
    return Plan(mesh=mesh, rules=rules, dp_axes=dp, kv_axes=tuple(kv_axes),
                expert_axes=expert_axes, moe_variant=variant,
                param_specs=specs, policy=policy)


def local_slice(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each sharded dim split
    into as many equal blocks as its axes hold ranks, the block at this
    rank's combined index over them (a view, no copy)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = mesh.axis_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axes) * size, size)
    return x


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's slice of every leaf of ``tree`` under the matching leaf
    of ``specs`` (a Spec, or a dict of them mirroring the tree)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs if isinstance(specs, Spec)
                              else specs[k], mesh)
                for k, v in tree.items()}
    return local_slice(tree, specs, mesh)
