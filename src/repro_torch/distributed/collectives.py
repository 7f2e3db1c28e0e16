"""Collectives of the PyTorch port (``repro/distributed/collectives.py``).

There is no ``shard_map``: a local body runs on every rank with that
rank's slices, and calls ``torch.distributed`` collectives on the process
group of the mesh axes it reduces over (``launch.mesh.Mesh.group``).

``make_seq_sharded_attn`` shards the KV cache along the sequence axis: at
each decode step the (tiny) per-token q is replicated, every rank computes
attention partials against its slice of the ring, and the partials are
combined with a log-sum-exp-weighted sum.  Wire bytes per step are
O(batch x heads x head_dim), independent of context length: move the
hidden state, not the KV cache.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group``; autograd passes through a
    sum (``torch.distributed.nn``), so the training bodies differentiate
    through it."""
    if op == dist.ReduceOp.SUM and x.requires_grad:
        from torch.distributed.nn.functional import all_reduce as _ar
        return _ar(x, op=op, group=group)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def lse_combine(o, m, l, mesh: Mesh, axes):
    """Combine attention partials across the mesh ``axes``.
    o: (B,H,Dv) f32 unnormalized; m, l: (B,H) f32.  One max and one sum
    (l rides beside o)."""
    group = mesh.group(axes)
    m_glob = all_reduce(m, group, dist.ReduceOp.MAX)
    corr = torch.exp(m - m_glob)
    ol = all_reduce(torch.cat([o * corr[..., None], (l * corr)[..., None]],
                              -1), group)
    return ol[..., :-1] / torch.clamp(ol[..., -1:], min=1e-30)


def make_seq_sharded_attn(mesh: Mesh, dp_axes: Tuple[str, ...],
                          kv_axes: Tuple[str, ...]):
    """Returns fn(q, k, v, valid, *, scale, attn_softcap, impl) -> (B,H,Dv).

    Each rank passes its own slices: q (B,H,D), its rows over dp_axes,
    the same on every rank of kv_axes; k/v (B,W,Hkv,D*) and valid (B,W)
    bool, its slice of the ring over kv_axes.  Each rank's partials come
    from ``ops.gqa_decode`` (the kernel on the card, its plain version on
    the CPU; ``impl`` as there), whose (o_unnorm, m, l) with m = 0 for a
    row without a valid key is what ``lse_combine`` takes."""
    kv_axes = tuple(kv_axes)

    def fn(q, k, v, valid, *, scale, attn_softcap=0.0, impl="auto"):
        o, m, l = ops.gqa_decode(q, k, v, valid, scale=scale,
                                 attn_softcap=attn_softcap, impl=impl)
        return lse_combine(o, m, l, mesh, kv_axes).to(q.dtype)

    fn.kv_shards = mesh.axis_size(kv_axes)
    return fn


def moe_param_specs(cfg, expert_axes: Tuple[str, ...],
                    ffn_axes: Tuple[str, ...] = ()):
    """The local bodies' specs of one layer's MoE leaves: the experts over
    ``expert_axes``, each expert's FFN dim over ``ffn_axes``."""
    from repro_torch.distributed.sharding import Spec
    e_ax, f_ax = tuple(expert_axes) or None, tuple(ffn_axes) or None
    specs = {"router": Spec(), "wi": Spec(e_ax, None, None, f_ax),
             "wo": Spec(e_ax, f_ax)}
    if cfg.expert_dtype == "int8":
        specs["wi_scale"] = specs["wo_scale"] = Spec(e_ax)
    if cfg.num_shared_experts:
        specs["shared"] = {"wi": Spec(None, None, f_ax), "wo": Spec(f_ax)}
    return specs


def make_moe_shard_fn(mesh: Mesh, cfg, *, variant: str,
                      dp_axes: Tuple[str, ...], expert_axes: Tuple[str, ...],
                      use_kernels: bool = False,
                      capacity_factor: float = None,
                      ffn_axes: Tuple[str, ...] = ()):
    """A ``moe_ep_*`` body as a policy ``moe_fn``:
    fn(cfg, p, x3 (B,S,D), impl) -> (out (B,S,D), aux).

    ``p`` is this rank's slice of one layer's MoE leaves under
    ``fn.p_specs`` (``moe_param_specs``); ``x3`` this rank's rows over
    dp_axes, the same on every other rank.  The output is laid out as x3,
    and aux is its mean over every rank of the mesh.

    variant "ep_psum": tokens replicated over expert_axes; the output is
      summed.  With `ffn_axes`, each expert's FFN dim is also sharded over
      those axes and the sum covers both groups.
    variant "ep_a2a": the sequence is also sliced over the expert axes
      (but 'data', which the batch carries); routed tokens are exchanged
      with all-to-all, and the slices gathered back after the body."""
    from repro_torch.models import moe as moe_mod
    if variant == "ep_psum":
        body = functools.partial(moe_mod.moe_ep_psum_local, cfg, mesh=mesh,
                                 expert_axes=expert_axes,
                                 use_kernel=use_kernels,
                                 capacity_factor=capacity_factor,
                                 ffn_axes=tuple(ffn_axes))
        seq_axes = ()
    elif variant == "ep_a2a":
        seq_axes = tuple(a for a in expert_axes if a != "data")
        body = functools.partial(moe_mod.moe_ep_a2a_local, cfg, mesh=mesh,
                                 expert_axes=expert_axes,
                                 use_kernel=use_kernels,
                                 capacity_factor=capacity_factor)
    else:
        raise ValueError(variant)
    seq_axes = mesh.in_mesh_order(seq_axes)

    def fn(cfg_, p, x3, impl="auto"):
        B, S, D = x3.shape
        if seq_axes:
            n = mesh.axis_size(seq_axes)
            s = S // n
            x3 = x3.narrow(1, mesh.axis_index(seq_axes) * s, s)
        out, aux = body(p, x3.reshape(-1, D), impl=impl)
        out = out.reshape(B, -1, D)
        if seq_axes:
            from torch.distributed.nn.functional import all_gather
            out = torch.cat(all_gather(out, group=mesh.group(seq_axes)), 1)
        aux = all_reduce(aux, mesh.group(mesh.axis_names)) / mesh.size
        return out, aux

    fn.p_specs = moe_param_specs(cfg, expert_axes, ffn_axes)
    return fn
