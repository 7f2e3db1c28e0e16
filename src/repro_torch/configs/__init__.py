"""Architecture registry of the PyTorch port: ``get_config("mixtral-8x7b")``.

The port carries the configs its slices run: the paper's own model
(mixtral-8x7b), the dense qwen2.5-3b, the MLA model deepseek-v3-671b,
gemma2-2b (window/global alternation, attention and final-logit softcaps,
head_dim 256), glm4-9b (QKV bias, 16 query heads a KV head), olmo-1b
(non-parametric LayerNorm, MHA), the 64-expert MoE
moonshot-v1-16b-a3b, the attention-free Mamba-2 model mamba2-1.3b and the
hybrid jamba-1.5-large-398b (Mamba-2 mixers, one attention layer a period
of 8, a 16-expert MoE on every other layer), the encoder-decoder
whisper-small (its decoder cross-attends the encoder's output) and the
VLM paligemma-3b (a prefix of patch embeddings before the text).
``get_config(arch).smoke()`` is the reduced same-family config the CPU tests
use.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      shape_applicable)

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "gemma2-2b": "gemma2_2b",
    "glm4-9b": "glm4_9b",
    "olmo-1b": "olmo_1b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-small": "whisper_small",
    "paligemma-3b": "paligemma_3b",
}

ALL_ARCHS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _cache:
        if arch not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
        mod = importlib.import_module(
            f"repro_torch.configs.{_ARCH_MODULES[arch]}")
        _cache[arch] = mod.CONFIG
    return _cache[arch]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config",
           "shape_applicable", "ALL_ARCHS"]
