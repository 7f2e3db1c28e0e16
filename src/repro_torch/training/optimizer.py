"""AdamW (``repro/training/optimizer.py``), updating in place.

The same math and order as the reference: linear warmup, global-norm
clipping, bias correction, decoupled weight decay, moments kept in
``moment_dtype``.  Where JAX builds new trees, this runs under
``torch.no_grad()`` and rewrites ``params``, ``mu`` and ``nu`` in place,
one leaf and one slice of it (a layer, or an expert of a layer) at a
time, so the float32 temporaries are those of one slice: at mixtral's
full width one stacked ``wi`` leaf of 2 layers holds 1.88 G elements,
7.5 GB for each f32 copy of it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import torch

from repro_torch.models.common import torch_dtype

SLICE_ELEMS = 1 << 28      # elements of the largest slice updated at once


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def tree_leaves(tree) -> List:
    """The leaves of a nested dict in sorted-key order (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def trainable(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def init_opt_state(params, opt: OptConfig) -> Dict:
    dt = torch_dtype(opt.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(opt: OptConfig, step: int) -> torch.Tensor:
    warm = torch.clamp(torch.tensor(float(step), dtype=torch.float32)
                       / max(opt.warmup_steps, 1), max=1.0)
    return opt.lr * warm


def slices(*tensors) -> Iterator[Tuple]:
    """Matching slices of same-shape tensors, each of at most SLICE_ELEMS
    elements where the leading axes allow: split along axis 0 (layers),
    then within each part along the next (experts), and so on."""
    t0 = next(t for t in tensors if t is not None)
    if t0.dim() == 0 or t0.numel() <= SLICE_ELEMS:
        yield tensors
        return
    n = min(t0.shape[0], math.ceil(t0.numel() / SLICE_ELEMS))
    if n < t0.shape[0]:
        parts = zip(*(torch.tensor_split(t, n) if t is not None
                      else [None] * n for t in tensors))
        yield from parts
        return
    for i in range(t0.shape[0]):
        yield from slices(*(t[i] if t is not None else None
                            for t in tensors))


def global_norm(tree, shard=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a None leaf, a
    parameter no gradient reached, counts 0).  ``shard``: the leaves are
    this rank's slices of a plan's (``ShardCtx.sq_norm``)."""
    if shard is not None:
        return torch.sqrt(shard.sq_norm(tree))
    sq = None
    for g in tree_leaves(tree):
        if g is None:
            continue
        for (s,) in slices(g):
            v = torch.sum(torch.square(s.float()))
            sq = v if sq is None else sq + v
    if sq is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(params, grads, state: Dict, opt: OptConfig, shard=None
                  ) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step, in place on params, state["mu"], state["nu"]; a None
    gradient is a zero one.  ``shard``: each leaf is this rank's slice
    under a plan, clipped by the whole gradients' norm.  Returns (params,
    state, metrics)."""
    state["step"].add_(1)
    step = int(state["step"])
    gnorm = global_norm(grads, shard)
    clip = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(opt, step)
    b1, b2 = opt.b1, opt.b2
    bc1 = 1 - b1 ** torch.tensor(float(step), dtype=torch.float32)
    bc2 = 1 - b2 ** torch.tensor(float(step), dtype=torch.float32)
    # lr, bc1 and bc2 are 0-dim CPU tensors, which PyTorch takes as scalars
    # beside a tensor on any device
    flat = zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state["mu"]), tree_leaves(state["nu"]))
    for p, g, mu, nu in flat:
        if not trainable(p):
            continue
        for ps, gs, mus, nus in slices(p, g, mu, nu):
            g32 = (torch.zeros(ps.shape, dtype=torch.float32,
                               device=ps.device) if gs is None
                   else gs.float() * clip)
            mu32 = mus.float() * b1 + (1 - b1) * g32
            nu32 = nus.float() * b2 + (1 - b2) * torch.square(g32)
            del g32
            mus.copy_(mu32)
            nus.copy_(nu32)
            mhat = mu32 / bc1
            del mu32
            delta = mhat / (torch.sqrt(nu32 / bc2) + opt.eps)
            del mhat, nu32
            if opt.weight_decay:
                delta = delta + opt.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
