"""Losses (``repro/training/losses.py``).  Cross-entropy is computed in
sequence chunks, each under ``torch.utils.checkpoint`` (what
``jax.checkpoint`` does in the reference), so the (B, S, vocab) float32
logits are never held whole: a chunk's logits are recomputed in the
backward.  Under a plan over more than one rank (``shard``) each rank takes
its columns of the logits (the vocab-parallel cross-entropy,
``tensor_parallel.vocab_xent``) on its rows of the batch, and the mean is
over the global mask count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.model import unembed


def xent(logits, targets, mask):
    """logits (T,V) f32; targets (T,) integer; mask (T,) f32.
    Returns (sum_loss, sum_mask)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[:, None].long())[:, 0]
    nll = (logz - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def chunked_lm_loss(cfg: ModelConfig, params, hidden, targets, *,
                    mask=None, chunk: int = 512, shard=None):
    """hidden (B,S,E); targets (B,S).  Mean NLL over mask (defaults to
    targets >= 0, with the vision prefix masked for VLMs).  ``shard``: this
    rank's rows over the plan's dp axes; the sums are taken over them, the
    loss's with an identity backward, so each rank's gradient is its rows'
    share."""
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
        # recomputed in backward
        logits = unembed(cfg, params, h, shard=shard, vocab_local=True)
        args = (logits.reshape(-1, logits.shape[-1]), t.reshape(-1),
                m.reshape(-1))
        if shard is not None and logits.shape[-1] != cfg.vocab_size:
            return TP.vocab_xent(shard, *args)
        return xent(*args)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s, n = checkpoint(body, hidden[:, sl], tgt[:, sl], mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    if shard is not None:
        dp = shard.group(shard.dp_axes)
        tot, cnt = C.reduce_from(tot, dp), C.all_reduce(cnt, dp)
    return tot / torch.clamp(cnt, min=1.0)
