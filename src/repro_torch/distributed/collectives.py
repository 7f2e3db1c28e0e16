"""Collectives of the PyTorch port (``repro/distributed/collectives.py``).

There is no ``shard_map``: a local body runs on every rank with that
rank's slices, and calls ``torch.distributed`` collectives on the process
group of the mesh axes it reduces over (``launch.mesh.Mesh.group``).

Autograd goes through Megatron's conjugate pairs, each a
``torch.autograd.Function`` whose backward is the forward's transpose for
a loss that every rank of the group computes alike:

  * ``copy_to``      identity forward, all-reduce backward (a replicated
                     activation entering a region split over the group);
  * ``reduce_from``  all-reduce forward, identity backward (the region's
                     partial results summed back into a replicated one);
  * ``gather_from``  all-gather forward, this rank's slice backward;
  * ``scatter_to``   this rank's slice forward, all-gather backward;
  * ``fsdp_gather``  all-gather forward, reduce-scatter backward (a leaf
                     split over the data axes, gathered at its use);
  * ``reduce_scatter`` its transpose: reduce-scatter forward, all-gather
                     backward.

``all_reduce`` is the plain reduced copy, with no gradient.

Only all-reduce (sum and max) is called on a process group: gloo, the
backend of two ranks on one card, has no CUDA form of the others.  So the
all-gather is composed as an all-reduce of a zero buffer in which each rank
fills its own block, the reduce-scatter as an all-reduce followed by
``narrow``, and the all-to-all as an all-reduce of a (ranks x ranks) grid
of blocks of which each rank fills its own row; a sum with zeros is exact,
so each gives the bits of the direct collective.  The same composition runs
on every backend.  Nothing leaves the device but what the backend itself
stages.

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


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group`` (None: one rank), with no
    gradient."""
    out = x.detach().clone()
    if _size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x, group, dim: int):
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order: an all-reduce of a zero buffer holding this rank's block."""
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * _size(group)
    buf = x.new_zeros(shape)
    buf.narrow(dim, dist.get_rank(group) * n, n).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf


def _block(x, group, dim: int):
    """This rank's block of ``x`` along ``dim`` (a copy)."""
    n = x.shape[dim] // _size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n).contiguous()


def _reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(_reduce(g, ctx.group), ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(_reduce(x, group), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to(x, group):
    """Identity forward; backward all-reduces the gradient over ``group``."""
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Sum over ``group`` forward; identity backward."""
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int):
    """The group's blocks concatenated along ``dim`` forward; this rank's
    block of the gradient backward."""
    return x if _size(group) == 1 else _GatherFrom.apply(x, group, dim)


def scatter_to(x, group, dim: int):
    """This rank's block along ``dim`` forward; the gradient's blocks
    gathered backward."""
    return x if _size(group) == 1 else _ScatterTo.apply(x, group, dim)


def fsdp_gather(x, group, dim: int):
    """A leaf's blocks gathered along ``dim`` forward; the gradient summed
    over ``group`` and cut to this rank's block backward."""
    return x if _size(group) == 1 else _FsdpGather.apply(x, group, dim)


def reduce_scatter(x, group, dim: int):
    """Sum over ``group`` cut to this rank's block along ``dim`` forward;
    the gradient's blocks gathered backward."""
    return x if _size(group) == 1 else _ReduceScatter.apply(x, group, dim)


def _a2a(x, group):
    n, me = _size(group), dist.get_rank(group)
    blocks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    grid = x.new_zeros((n,) + tuple(blocks.shape))
    grid[me] = blocks
    dist.all_reduce(grid, group=group)
    return grid[:, me].reshape(x.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g.contiguous(), ctx.group), None


def all_to_all(x, group):
    """Block i of x's leading axis (cut into as many equal blocks as the
    group has ranks) to rank i of ``group``; the blocks received, in rank
    order.  Its gradient goes back the same way (for floating x)."""
    if _size(group) == 1:
        return x.clone()
    if x.is_floating_point():
        return _AllToAll.apply(x, group)
    return _a2a(x, group)


def lse_combine(o, m, l, mesh: Mesh, axes):
    """Combine attention partials across the mesh ``axes``.
    o: (B,H,Dv) f32 unnormalized; m, l: (B,H) f32.  One max and one sum
    (l rides beside o)."""
    group = mesh.group(axes)
    m_glob = all_reduce(m, group, dist.ReduceOp.MAX)
    corr = torch.exp(m - m_glob)
    ol = reduce_from(torch.cat([o * corr[..., None], (l * corr)[..., None]],
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
                      ffn_axes: Tuple[str, ...] = (), tp: bool = False):
    """A ``moe_ep_*`` body as a policy ``moe_fn``:
    fn(cfg, p, x3 (B,S,D), impl) -> (out (B,S,D), aux).

    ``p`` is this rank's slice of one layer's MoE leaves under
    ``fn.p_specs`` (``moe_param_specs``); ``x3`` this rank's rows over
    dp_axes, the same on every other rank.  The output is laid out as x3,
    and aux is its mean over every rank of the mesh (under ``tp``, the
    global batch's).

    variant "ep_psum": tokens replicated over expert_axes; the output is
      summed.  With `ffn_axes`, each expert's FFN dim is also sharded over
      those axes and the sum covers both groups.  A decode body: under
      ``tp`` its backward raises (the router's gradient would be partial).
    variant "ep_a2a": the sequence is also sliced over the expert axes
      (but 'data', which the batch carries); routed tokens are exchanged
      with all-to-all, and the slices gathered back after the body.

    tp (a step of a plan over more than one rank): aux is the load-balance
    loss of the global batch, from f_e and P_e summed over the axes that
    split the tokens (dp_axes, and the sequence's axes) before their
    product, and the router, whole on every rank, gets its gradient summed
    over the sequence's axes."""
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
    tok_axes = tuple(dp_axes) + seq_axes

    def fn(cfg_, p, x3, impl="auto"):
        B, S, D = x3.shape
        seq = mesh.group(seq_axes) if seq_axes else None
        kw = {}
        if tp:
            if (variant == "ep_psum" and torch.is_grad_enabled()
                    and x3.requires_grad and mesh.axis_size(expert_axes) > 1):
                raise NotImplementedError(
                    "a backward through the ep_psum body over more than one "
                    "rank is not ported: the train plans run ep_a2a or the "
                    "grouped MoE")
            kw["aux_group"] = (mesh.group(tok_axes)
                               if mesh.axis_size(tok_axes) > 1 else None)
            p = dict(p, router=copy_to(p["router"], seq))
        if seq_axes:
            x3 = scatter_to(x3, seq, 1)
        out, aux = body(p, x3.reshape(-1, D), impl=impl, **kw)
        out = out.reshape(B, -1, D)
        if seq_axes:
            out = gather_from(out, seq, 1)
        if not tp:
            aux = reduce_from(aux, mesh.group(mesh.axis_names)) / mesh.size
        return out, aux

    fn.p_specs = moe_param_specs(cfg, expert_axes, ffn_axes)
    return fn
