"""Token sampling (``repro/serving/sampling.py``): greedy only.  Sampling
at a temperature is a later slice."""
from __future__ import annotations

import torch


def sample(logits):
    """logits (B,V) f32 -> greedy tokens (B,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
