"""Architecture registry of the PyTorch port: ``get_config("mixtral-8x7b")``.

The port carries the configs its slices run: the paper's own model
(mixtral-8x7b) and the dense qwen2.5-3b.  ``get_config(arch).smoke()`` is
the reduced same-family config the CPU tests use.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      shape_applicable)

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "mixtral-8x7b": "mixtral_8x7b",
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
