"""Input specs for every (architecture × shape) cell as tensors on the
``meta`` device, and concrete random inputs for smoke runs — the
counterpart of ``repro/models/inputs.py``.

``input_specs`` gives the shapes and dtypes of the inputs a train, prefill
or decode forward takes (the stubbed modality frontends' outputs
included), without storage; ``concrete_inputs`` draws them from a seed
with numpy, in the reference's order, so that one seed gives both packages
the same arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import kvcache
from repro_torch.models.common import torch_dtype


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def modality_specs(cfg: ModelConfig, batch: int) -> Dict:
    """The stubbed modality frontends' outputs (precomputed embeddings):
    whisper's audio frames and paligemma's image patches."""
    extra = {}
    dt = torch_dtype(cfg.dtype)
    if cfg.encoder_layers:
        extra["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.vision_tokens:
        extra["patches"] = _meta((batch, cfg.vision_tokens, cfg.d_model), dt)
    return extra


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The inputs of the forward that ``shape.mode`` implies, as meta
    tensors; decode's cache is ``kvcache.abstract_cache``."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        specs = {"tokens": _meta((B, S), torch.int32),
                 "targets": _meta((B, S), torch.int32)}
        specs.update(modality_specs(cfg, B))
        return specs
    if shape.mode == "prefill":
        specs = {"tokens": _meta((B, S), torch.int32)}
        specs.update(modality_specs(cfg, B))
        return specs
    if shape.mode == "decode":
        # one new token against a cache of length seq_len (an enc-dec
        # model's decode reads the encoder K, V the cache already holds)
        return {"tokens": _meta((B, 1), torch.int32),
                "cache": kvcache.abstract_cache(cfg, B, S)}
    raise ValueError(shape.mode)


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                    device: DeviceLike = None) -> Dict:
    """Random concrete inputs matching ``input_specs`` on ``device``: token
    ids uniform over the vocabulary and embeddings N(0, 1), drawn from
    ``np.random.default_rng(seed)`` in the specs' order (the reference's
    draws); a decode cache is empty with ``pos`` at half its length."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in input_specs(cfg, shape).items():
        if name == "cache":
            cache = kvcache.init_cache(cfg, shape.global_batch, shape.seq_len,
                                       device=device)
            cache["pos"].fill_(shape.seq_len // 2)   # half full
            out[name] = cache
        elif spec.dtype == torch.int32:
            out[name] = torch.from_numpy(rng.integers(
                0, max(cfg.vocab_size, 2), spec.shape).astype(np.int32)).to(
                    device)
        else:
            # through float32, as the reference converts the float64 draw
            out[name] = torch.from_numpy(rng.normal(
                0, 1, spec.shape).astype(np.float32)).to(device, spec.dtype)
    return out
