"""Train step (``repro/training/train_step.py``): forward → chunked LM loss
(+ MoE aux) → backward → clip → AdamW, in place.

The gradients are those of the leaves that require grad (the trainer sets
it on every floating leaf); a leaf no gradient reaches counts as a zero
gradient, as ``jax.value_and_grad`` gives it.  On CUDA tensors every
attention layer's backward runs the ``flash_prefill_bwd`` kernel
(``kernels.ops.flash_prefill``); the MoE trains through ``moe_dense``
(policy None), as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import ExecPolicy, forward
from repro_torch.training.losses import chunked_lm_loss
from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                            tree_leaves, tree_map)

AUX_LOSS_WEIGHT = 0.01


def make_loss_fn(cfg: ModelConfig, policy: Optional[ExecPolicy]) -> Callable:
    def loss_fn(params, batch):
        extras = {k: batch[k] for k in ("frames", "patches") if k in batch}
        out = forward(cfg, params, batch["tokens"], mode="train",
                      policy=policy, **extras)
        lm = chunked_lm_loss(cfg, params, out["hidden"], batch["targets"])
        aux = out["aux_loss"]
        loss = lm + AUX_LOSS_WEIGHT * aux
        return loss, {"lm_loss": lm, "aux_loss": aux}
    return loss_fn


def requires_grad_(params) -> Dict:
    """Mark every floating leaf as trainable (in place); returns params."""
    for p in tree_leaves(params):
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def value_and_grad(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Dict, Dict]:
    """(loss, metrics, grads): grads mirrors params, a tensor of the
    leaf's dtype for each leaf that requires grad and that the loss
    reaches, else None.  The metrics are detached."""
    leaves = [p for p in tree_leaves(params) if p.requires_grad]
    loss, metrics = loss_fn(params, batch)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): g for p, g in zip(leaves, got)}
    grads = tree_map(lambda p: by_id.get(id(p)), params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, opt: OptConfig,
                    policy: Optional[ExecPolicy] = None) -> Callable:
    loss_fn = make_loss_fn(cfg, policy)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_microbatched_train_step(cfg: ModelConfig, opt: OptConfig,
                                 policy: Optional[ExecPolicy],
                                 num_micro: int) -> Callable:
    """Gradient accumulation in f32 over `num_micro` micro-batches (the
    batch's rows split in order), the training analogue of the paper's μ:
    bounds activation memory while the update is the full batch's."""
    loss_fn = make_loss_fn(cfg, policy)

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        assert B % num_micro == 0
        mb = B // num_micro
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        acc_l = 0.0
        for i in range(num_micro):
            mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, grads = value_and_grad(loss_fn, params, mbatch)
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                if g is not None:
                    a.add_(g.float() / num_micro)
            acc_l = acc_l + loss / num_micro
            del grads
        params, opt_state, opt_metrics = apply_updates(
            params, acc, opt_state, opt)
        return params, opt_state, {"loss": acc_l, **opt_metrics}

    return train_step
