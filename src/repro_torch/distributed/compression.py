"""Gradient compression with error feedback, for the slow cross-pod
all-reduce of multi-pod training (``repro/distributed/compression.py``).

int8 path: symmetric quantization with one scale shared by the group (its
max by ``all_reduce(MAX)``), the sum in int32 (exact on the quantized
values), dequantized, with the quantization residual fed back into the
next step (error feedback keeps SGD converging — Karimireddy et al. 2019).
bf16 path: downcast, sum, upcast.  Plain path: an f32 sum.

Compression applies to the cross-pod hop only; the reduction inside a pod
stays full precision.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(grad, group, *, method: str = "int8",
                    error: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum ``grad`` over the ranks of ``group`` in compressed form.
    Returns (reduced_grad f32, new_error); ``error`` is this rank's
    residual of the previous step."""
    g = grad.to(torch.float32)
    if error is not None:
        g = g + error
    if method == "int8":
        # a scale shared across the group, so the int32 sum is exact
        amax = torch.max(torch.abs(g))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_error = g - q.to(torch.float32) * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        out = total.to(torch.float32) * scale
    elif method == "bf16":
        c = g.to(torch.bfloat16)
        new_error = g - c.to(torch.float32)
        dist.all_reduce(c, group=group)
        out = c.to(torch.float32)
    elif method == "none":
        out = g.clone()
        dist.all_reduce(out, group=group)
        new_error = torch.zeros_like(g)
    else:
        raise ValueError(f"method must be int8, bf16 or none: {method!r}")
    return out, new_error


def tree_compressed_psum(grads: Dict, group, method: str = "int8",
                         errors: Optional[Dict] = None
                         ) -> Tuple[Dict, Dict]:
    """``compressed_psum`` over a dict tree, threading the error-feedback
    state (a tree like ``grads``, or None at the first step)."""
    if not isinstance(grads, dict):
        return compressed_psum(grads, group, method=method, error=errors)
    outs, errs = {}, {}
    for k, g in grads.items():
        outs[k], errs[k] = tree_compressed_psum(
            g, group, method, None if errors is None else errors[k])
    return outs, errs
