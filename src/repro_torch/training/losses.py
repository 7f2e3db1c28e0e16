"""Losses (``repro/training/losses.py``).  Cross-entropy is computed in
sequence chunks, each under ``torch.utils.checkpoint`` (what
``jax.checkpoint`` does in the reference), so the (B, S, vocab) float32
logits are never held whole: a chunk's logits are recomputed in the
backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import unembed


def xent(logits, targets, mask):
    """logits (T,V) f32; targets (T,) integer; mask (T,) f32.
    Returns (sum_loss, sum_mask)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[:, None].long())[:, 0]
    nll = (logz - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def chunked_lm_loss(cfg: ModelConfig, params, hidden, targets, *,
                    mask=None, chunk: int = 512):
    """hidden (B,S,E); targets (B,S).  Mean NLL over mask (defaults to
    targets >= 0, with the vision prefix masked for VLMs)."""
    B, S, E = hidden.shape
    if mask is None:
        mask = targets >= 0
        if cfg.vision_tokens:
            pos = torch.arange(S, device=targets.device)[None, :]
            mask = mask & (pos >= cfg.vision_tokens)
    mask = mask.to(torch.float32)
    tgt = torch.clamp(targets, min=0)

    nchunks = -(-S // chunk)
    pad = nchunks * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        tgt = F.pad(tgt, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(h, t, m):
        logits = unembed(cfg, params, h)       # recomputed in backward
        return xent(logits.reshape(-1, logits.shape[-1]), t.reshape(-1),
                    m.reshape(-1))

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s, n = checkpoint(body, hidden[:, sl], tgt[:, sl], mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
