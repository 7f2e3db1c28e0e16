"""Token sampling (``repro/serving/sampling.py``): greedy at temperature 0,
otherwise a categorical draw from ``softmax(logits / T)``, optionally
restricted to the ``top_k`` largest logits.

The draw is the Gumbel-max form of a categorical sample (``argmax(logits +
G)`` with G standard Gumbel noise), as ``jax.random.categorical`` computes
it, on uniforms from an explicit ``torch.Generator`` on the logits' device:
a sampler reproduces itself from its generator's seed and reads no global
random state.  JAX draws from split keys, so the draws themselves cannot
equal the reference's; their distribution and the top-k mask do."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """logits (B,V) f32 -> tokens (B,) int32.  `generator` (on the logits'
    device) is required when temperature > 0."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at a temperature needs a generator")
    logits = logits.float() / temperature
    if top_k:
        cut = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < cut, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)
