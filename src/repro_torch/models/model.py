"""Model assembly of the PyTorch port (``repro/models/model.py``):
embedding → prologue blocks → periodic blocks → final norm → unembed, for
the attention families the port runs (GQA and MLA attention with dense or
MoE FFNs).

JAX's ``lax.scan`` over the stacked layers becomes a Python loop over layer
slices: each layer's parameters and cache are views into the stacked
tensors, so the ring writes of a layer land in the stacked cache.

Execution strategy is injected through an `ExecPolicy`, as in the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import attn_forward
from repro_torch.models.common import act_fn, apply_norm, softcap
from repro_torch.models.moe import gated_ffn, moe_apply


@dataclass
class ExecPolicy:
    """How to execute (not what to compute)."""
    moe_impl: str = "dense"               # dense | grouped
    use_kernels: bool = False             # grouped MoE FFN through moe_ffn
    impl: str = "auto"                    # kernel dispatch (kernels/ops.py):
    # auto (the CUDA kernels on CUDA tensors, plain PyTorch on CPU) | ref
    # (the kernels' plain versions everywhere)


def dense_ffn(cfg: ModelConfig, p: Dict, x):
    if cfg.ffn_act == "gelu_mlp":
        h = act_fn("gelu_mlp")(torch.matmul(x, p["wi"].to(x.dtype))
                               + p["bi"].to(x.dtype))
        return torch.matmul(h, p["wo"].to(x.dtype)) + p["bo"].to(x.dtype)
    return gated_ffn(cfg, p["wi"], p["wo"], x)


def block_apply(cfg: ModelConfig, spec: LayerSpec, p: Dict, x, *, positions,
                cache: Optional[Dict], mode: str, pos,
                policy: Optional[ExecPolicy]):
    """One layer.  Returns (x, aux_loss); a given cache is written in place."""
    aux = 0.0
    h = apply_norm(cfg, p.get("attn_norm", {}), x)
    y, _ = attn_forward(cfg, spec, p["attn"], h, positions, cache=cache,
                        mode=mode, pos=pos,
                        impl=policy.impl if policy else "auto")
    if cfg.post_block_norm:
        y = apply_norm(cfg, p["post_attn_norm"], y)
    x = x + y
    if spec.ffn:
        h = apply_norm(cfg, p.get("ffn_norm", {}), x)
        if spec.moe:
            y, aux = moe_apply(cfg, p["moe"], h, policy)
        else:
            y = dense_ffn(cfg, p["ffn"], h)
        if cfg.post_block_norm:
            y = apply_norm(cfg, p["post_ffn_norm"], y)
        x = x + y
    return x, aux


def _layer(tree: Dict, i: int) -> Dict:
    """The i-th layer's slice of a stacked tree (views, no copies)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def embed_tokens(cfg: ModelConfig, params, tokens):
    x = params["embed"]["tokens"][tokens]            # (B,S,E) gather
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def forward(cfg: ModelConfig, params, tokens, *, cache=None, mode="train",
            policy: Optional[ExecPolicy] = None):
    """tokens: (B,S) integer.  mode: train | prefill | decode.
    Returns dict(hidden, cache, aux_loss); call `unembed` for logits.

    prefill writes the prompt's KV into the cache ring at positions 0..S-1;
    decode reads and writes it at each row's ``cache["pos"]``.  The cache
    is updated in place and returned (its "pos" advances by S, or 1).
    The prologue's layers (``params["prologue"]["p0"]``, with their dense
    rings in ``cache["prologue"]``) run before the periodic stack."""
    if cfg.encoder_layers or cfg.vision_tokens or cfg.pos == "learned":
        raise NotImplementedError(f"{cfg.name}: not ported yet")
    B, S = tokens.shape
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        pos = cache["pos"]                           # (B,)
        positions = pos[:, None]
        run_mode = "decode"
    else:
        pos = None
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        run_mode = "full"

    x = embed_tokens(cfg, params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    # the prologue's layers share its first spec, as they share one stack
    stacks = [(cfg.prologue[0], params["prologue"]["p0"], "prologue", layer)
              for layer in range(len(cfg.prologue))]
    stacks += [(spec, params["blocks"][f"p{i}"], f"p{i}", layer)
               for layer in range(cfg.num_periods)
               for i, spec in enumerate(cfg.period)]
    for spec, p, key, layer in stacks:
        x, aux = block_apply(
            cfg, spec, _layer(p, layer), x, positions=positions,
            cache=_layer(cache[key], layer) if cache is not None else None,
            mode=run_mode, pos=pos, policy=policy)
        aux_total = aux_total + aux
    if cache is not None:
        cache["pos"] = cache["pos"] + (1 if mode == "decode" else S)

    x = apply_norm(cfg, params.get("final_norm", {}), x)
    return {"hidden": x, "cache": cache, "aux_loss": aux_total}


def unembed(cfg: ModelConfig, params, hidden):
    """hidden: (..., E) -> logits (..., V) float32 (with gemma2 softcap)."""
    if cfg.tie_embeddings:
        logits = torch.matmul(hidden.float(),
                              params["embed"]["tokens"].float().t())
    else:
        logits = torch.matmul(hidden.float(), params["lm_head"].float())
    return softcap(logits, cfg.logit_softcap)
