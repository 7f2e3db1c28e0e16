"""Weights from numpy into the port: the bridge the parity tests use to run
the JAX package and the port on the same parameters.

``params_from_numpy(jax.tree.map(np.asarray, params))`` turns the JAX
parameter pytree (nested dicts of arrays) into the port's dict of tensors
with the same keys, shapes and dtypes, so both packages compute the same
function.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """One leaf.  numpy has no native bfloat16: JAX hands out ml_dtypes'
    bfloat16, whose bits are reinterpreted as torch.bfloat16 unchanged."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    device = resolve_device(device)
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else tensor_from_numpy(v, device))
            for k, v in tree.items()}
