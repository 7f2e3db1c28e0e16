"""Parameter definitions of the PyTorch port (``repro/models/params.py``).

A model's parameters are a nested dict of `ParamDef`s, each carrying a
shape, a tuple of logical axis names (one per dim) and an init recipe.  From
this one source come:

  * `init_params`  — materialized, randomly initialized dict of tensors
  * `count_params` — exact parameter counts (total / active-per-token)

Stacking matches the JAX package: the layers of each position in the
repeating period are stacked on a leading "layers" axis, so the keys,
shapes and stacking of both packages are the same (``models.convert``
moves JAX weights over leaf by leaf).  The port covers the attention
families it runs — GQA attention with dense or MoE FFNs; MLA, mamba,
prologue and encoder layers raise until their slice is ported.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_MLA, LayerSpec, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import torch_dtype


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis names
    init: str = "normal"                # normal | zeros | ones | embed | qscale
    fan_in: int = 0                     # for scaled-normal init
    dtype: str = ""                     # "" = model dtype; e.g. "int8"


def _lin(d_in, d_out, ax_in, ax_out, stack=0) -> ParamDef:
    shape, axes = (d_in, d_out), (ax_in, ax_out)
    if stack:
        shape, axes = (stack,) + shape, ("layers",) + axes
    return ParamDef(shape, axes, "normal", fan_in=d_in)


def _vec(d, ax, init="zeros", stack=0) -> ParamDef:
    shape, axes = (d,), (ax,)
    if stack:
        shape, axes = (stack,) + shape, ("layers",) + axes
    return ParamDef(shape, axes, init)


def _norm_def(cfg: ModelConfig, stack: int) -> Dict[str, ParamDef]:
    if cfg.norm == "rmsnorm":
        init = "zeros" if cfg.scale_embeddings else "ones"  # gemma stores w, uses 1+w
        return {"scale": _vec(cfg.d_model, "embed_nr", init, stack)}
    if cfg.norm == "layernorm":
        return {"scale": _vec(cfg.d_model, "embed_nr", "ones", stack),
                "bias": _vec(cfg.d_model, "embed_nr", "zeros", stack)}
    if cfg.norm == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm)


def _attn_defs(cfg: ModelConfig, spec: LayerSpec, stack: int) -> Dict[str, ParamDef]:
    if spec.attn == ATTN_MLA:
        raise NotImplementedError("MLA attention is not ported yet")
    E, Dh = cfg.d_model, cfg.head_dim
    d = {
        "wq": _lin(E, cfg.num_heads * Dh, "embed", "heads", stack),
        "wk": _lin(E, cfg.num_kv_heads * Dh, "embed", "kv_heads", stack),
        "wv": _lin(E, cfg.num_kv_heads * Dh, "embed", "kv_heads", stack),
        "wo": _lin(cfg.num_heads * Dh, E, "heads", "embed", stack),
    }
    if cfg.qkv_bias:
        d["bq"] = _vec(cfg.num_heads * Dh, "heads", "zeros", stack)
        d["bk"] = _vec(cfg.num_kv_heads * Dh, "kv_heads", "zeros", stack)
        d["bv"] = _vec(cfg.num_kv_heads * Dh, "kv_heads", "zeros", stack)
    return d


def _ffn_defs(cfg: ModelConfig, d_ff: int, stack: int) -> Dict[str, ParamDef]:
    E = cfg.d_model
    if cfg.ffn_act == "gelu_mlp":            # plain MLP (whisper)
        return {"wi": _lin(E, d_ff, "embed", "ffn", stack),
                "bi": _vec(d_ff, "ffn", "zeros", stack),
                "wo": _lin(d_ff, E, "ffn", "embed", stack),
                "bo": _vec(E, None, "zeros", stack)}
    # gated (SwiGLU / GeGLU): gate+up stored as (E, 2, F)
    shape_wi, axes_wi = (E, 2, d_ff), ("embed", None, "ffn")
    shape_wo, axes_wo = (d_ff, E), ("ffn", "embed")
    if stack:
        shape_wi, axes_wi = (stack,) + shape_wi, ("layers",) + axes_wi
        shape_wo, axes_wo = (stack,) + shape_wo, ("layers",) + axes_wo
    return {"wi": ParamDef(shape_wi, axes_wi, "normal", fan_in=E),
            "wo": ParamDef(shape_wo, axes_wo, "normal", fan_in=d_ff)}


def _moe_defs(cfg: ModelConfig, stack: int) -> Dict[str, ParamDef]:
    E, F, NE = cfg.d_model, cfg.d_ff, cfg.num_experts
    qdt = cfg.expert_dtype            # "" or "int8" (weight-only quant)
    shape_wi, axes_wi = (NE, E, 2, F), ("experts", "embed", None, "effn")
    shape_wo, axes_wo = (NE, F, E), ("experts", "effn", "embed")
    if stack:
        shape_wi, axes_wi = (stack,) + shape_wi, ("layers",) + axes_wi
        shape_wo, axes_wo = (stack,) + shape_wo, ("layers",) + axes_wo
    d = {
        "router": _lin(E, NE, "embed", None, stack),
        "wi": ParamDef(shape_wi, axes_wi, "normal", fan_in=E, dtype=qdt),
        "wo": ParamDef(shape_wo, axes_wo, "normal", fan_in=F, dtype=qdt),
    }
    if qdt == "int8":                 # per-expert dequant scales
        sshape = ((stack, NE) if stack else (NE,))
        saxes = (("layers", "experts") if stack else ("experts",))
        d["wi_scale"] = ParamDef(sshape, saxes, "qscale", fan_in=E,
                                 dtype="float32")
        d["wo_scale"] = ParamDef(sshape, saxes, "qscale", fan_in=F,
                                 dtype="float32")
    if cfg.num_shared_experts:
        d["shared"] = _ffn_defs(cfg, F * cfg.num_shared_experts, stack)
    return d


def _block_defs(cfg: ModelConfig, spec: LayerSpec, stack: int) -> Dict:
    if spec.kind == "mamba":
        raise NotImplementedError("mamba layers are not ported yet")
    if spec.cross_attn:
        raise NotImplementedError("cross-attention is not ported yet")
    d: Dict = {"attn": _attn_defs(cfg, spec, stack),
               "attn_norm": _norm_def(cfg, stack)}
    if cfg.post_block_norm:
        d["post_attn_norm"] = _norm_def(cfg, stack)
    if spec.ffn:
        if spec.moe:
            d["moe"] = _moe_defs(cfg, stack)
        else:
            d["ffn"] = _ffn_defs(cfg, cfg.dense_d_ff or cfg.d_ff, stack)
        d["ffn_norm"] = _norm_def(cfg, stack)
        if cfg.post_block_norm:
            d["post_ffn_norm"] = _norm_def(cfg, stack)
    return d


def param_defs(cfg: ModelConfig) -> Dict:
    if cfg.prologue or cfg.encoder_layers:
        raise NotImplementedError("prologue / encoder layers are not ported")
    defs: Dict = {
        "embed": {"tokens": ParamDef((cfg.vocab_size, cfg.d_model),
                                     ("vocab", "embed"), "embed",
                                     fan_in=cfg.d_model)},
        "final_norm": _norm_def(cfg, 0),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = _lin(cfg.d_model, cfg.vocab_size, "embed", "vocab")
    defs["blocks"] = {f"p{i}": _block_defs(cfg, spec, cfg.num_periods)
                      for i, spec in enumerate(cfg.period)}
    return defs


def _leaves(defs, path=()):
    """(path, ParamDef) pairs in sorted-key order (the JAX init order)."""
    if isinstance(defs, ParamDef):
        yield path, defs
        return
    for k in sorted(defs):
        yield from _leaves(defs[k], path + (k,))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX package's keys, shapes and stacking,
    drawn from ``generator`` (which must live on ``device``).  Normal
    leaves are drawn straight in their storage dtype, so a full-width
    model needs no float32 staging copy."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, "
                         f"parameters go to {device}")
    dtype = torch_dtype(cfg.dtype)
    out: Dict = {}
    for path, d in _leaves(param_defs(cfg)):
        ldt = torch_dtype(d.dtype) if d.dtype else dtype
        if d.init == "zeros":
            val = torch.zeros(d.shape, dtype=ldt, device=device)
        elif d.init == "ones":
            val = torch.ones(d.shape, dtype=ldt, device=device)
        elif d.init == "qscale":
            std = 1.0 / math.sqrt(max(d.fan_in, 1))
            val = torch.full(d.shape, std / 48.0, dtype=torch.float32,
                             device=device)
        elif d.dtype == "int8":
            val = torch.randn(d.shape, generator=generator, device=device)
            val = torch.clamp(torch.round(val * 48.0), -127, 127).to(
                torch.int8)
        else:
            std = (1.0 / math.sqrt(max(d.fan_in, 1))) if d.fan_in else 0.02
            val = torch.empty(d.shape, dtype=ldt, device=device)
            val.normal_(0.0, std, generator=generator)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return out


def count_params(cfg: ModelConfig, active_only: bool = False,
                 include_embed: bool = True) -> int:
    total = 0
    for _, d in _leaves(param_defs(cfg)):
        n = int(np.prod(d.shape))
        if "vocab" in d.axes and not include_embed:
            continue
        if active_only and "experts" in d.axes:
            n = n * cfg.top_k // cfg.num_experts
        total += n
    return total
