"""Tensor parallelism and FSDP of the PyTorch port: the work XLA's SPMD
partitioner does for the reference (no counterpart module there).

A sharding plan over more than one rank (``sharding.make_plan``) puts a
``ShardCtx`` in ``ExecPolicy.shard``.  Each rank then runs the model on its
slices of the parameters (``sharding.shard_tree`` by the plan's specs), its
rows of the batch over the dp axes and its slots of a decode ring over the
KV axes, and the local bodies meet through ``distributed.collectives``'
conjugate pairs, Megatron's scheme:

  * attention (``models.attention``) runs the heads of this rank: ``wq``,
    ``wk``, ``wv`` and their biases split by heads, ``wo`` by rows and
    followed by ``reduce_from``; a KV leaf left whole, or split finer than
    its heads, gives each rank the KV heads its query heads read;
  * the dense FFN (``models.model.dense_ffn``) splits ``wi`` by ``ffn`` and
    ``wo`` by rows, followed by ``reduce_from``;
  * the grouped MoE (``models.moe.moe_grouped_tp``) gathers the batch over
    the dp axes so that each expert's bucket holds the tokens it holds on
    one device, and runs this rank's experts, or every expert on this
    rank's slice of its FFN dim;
  * the vocabulary is split over ``vocab``'s axes: the embedding lookup
    masks the ids of other ranks' rows, ``unembed`` gives this rank's
    columns (gathered for a caller that wants whole logits) and the
    cross-entropy takes three all-reduces (max, sum of exp, gold logit),
    with no full-vocabulary tensor on any rank;
  * a leaf whose ``embed`` dim is split over the data axes (FSDP) is
    gathered at its use, its gradient reduce-scattered back.

Every rank of a dp group computes the global loss (the sums over the dp
axes taken with ``reduce_from``), so its gradients are its own rows'
shares: the train step sums a leaf's gradient over the dp axes the leaf is
whole over, and ``global_norm`` sums each leaf's squares over the axes it
is split on.

Not ported (a step at world size > 1 raises ``NotImplementedError``): the
Mamba-2 mixer's split, MLA, whisper's encoder and cross-attention,
paligemma's patch prefix, the stationary-weights decode (``decode_2d``),
chunked prefill, block-paged or int8 KV, and shared experts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_MLA, ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import Mesh, _as_tuple


@dataclass
class ShardCtx:
    """What a local body needs of its plan: the mesh, the logical-axis
    rules, the batch's and the decode ring's axes, the experts' axes, and
    each leaf's ``Spec`` with its logical axes (``params.param_axes``).
    Process groups are made when first asked for, so a plan over a mesh of
    names and sizes (the census, the production meshes) holds one too."""
    mesh: Mesh
    rules: Dict
    dp_axes: Tuple[str, ...]
    kv_axes: Tuple[str, ...]
    expert_axes: Tuple[str, ...]
    specs: Dict
    axes: Dict
    decode_2d: bool = False

    def group(self, axes):
        """The process group of ``axes``, or None where they hold one
        rank."""
        axes = _as_tuple(axes)
        return self.mesh.group(axes) if self.mesh.axis_size(axes) > 1 \
            else None

    def axes_of(self, logical: str) -> Tuple[str, ...]:
        return _as_tuple(self.rules.get(logical))

    def group_of(self, logical: str):
        return self.group(self.axes_of(logical))

    def index_of(self, logical: str) -> int:
        return self.mesh.axis_index(self.axes_of(logical))

    def ring(self, width: int) -> Tuple[int, int]:
        """(first slot, whole width) of this rank's block of a decode ring
        of ``width`` slots a rank."""
        return (self.mesh.axis_index(self.kv_axes) * width,
                width * self.mesh.axis_size(self.kv_axes))

    # ------------------------------------------------------------ FSDP

    def gather_fsdp(self, tree, path: Tuple[str, ...], stacked: bool):
        """``tree`` (the params at ``path``; a layer's slice of them if
        ``stacked``) with every leaf whose ``embed`` dim is split gathered
        whole along it (``collectives.fsdp_gather``)."""
        specs, axes = self.specs, self.axes
        for k in path:
            specs, axes = specs[k], axes[k]
        return self._gather(tree, specs, axes, 1 if stacked else 0)

    def _gather(self, t, spec, axes, off):
        if isinstance(t, dict):
            return {k: self._gather(v, spec[k], axes[k], off)
                    for k, v in t.items()}
        for dim, (name, part) in enumerate(zip(axes, spec)):
            if name == "embed" and part is not None:
                t = C.fsdp_gather(t, self.group(part), dim - off)
        return t

    # -------------------------------------------------------- gradients

    def _leaf_specs(self):
        from repro_torch.training.optimizer import tree_leaves
        return tree_leaves(self.specs)

    def reduce_grads(self, grads):
        """Sum each leaf's gradient over the dp axes it is whole over (in
        place); a leaf split over a dp axis had its sum from the
        collectives' backward."""
        from repro_torch.training.optimizer import tree_leaves
        for g, spec in zip(tree_leaves(grads), self._leaf_specs()):
            used = {a for part in spec for a in _as_tuple(part)}
            group = self.group(tuple(a for a in self.dp_axes
                                     if a not in used))
            if g is not None and group is not None:
                torch.distributed.all_reduce(g, group=group)
        return grads

    def sq_norm(self, grads) -> torch.Tensor:
        """The sum of squares of the whole gradients: each leaf's local
        sum, summed over the axes the leaf is split on (a whole leaf once),
        in f32."""
        from repro_torch.training.optimizer import slices, tree_leaves
        by_axes: Dict[Tuple[str, ...], torch.Tensor] = {}
        dev = None
        for g, spec in zip(tree_leaves(grads), self._leaf_specs()):
            if g is None:
                continue
            dev = g.device
            key = self.mesh.in_mesh_order(
                {a for part in spec for a in _as_tuple(part)})
            for (s,) in slices(g):
                v = torch.sum(torch.square(s.float()))
                by_axes[key] = by_axes[key] + v if key in by_axes else v
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for key in sorted(by_axes):
            total = total + C.all_reduce(by_axes[key], self.group(key))
        return total


def check_supported(cfg: ModelConfig, sh: ShardCtx, *, mode: str,
                    frames=None, patches=None) -> None:
    """Raise ``NotImplementedError`` for what a step at world size > 1
    does not run yet, rather than running it on whole weights."""
    specs = tuple(cfg.period) + tuple(cfg.prologue)
    missing = None
    if sh.decode_2d:
        missing = "the stationary-weights decode (decode_2d)"
    elif any(s.kind == "mamba" for s in specs):
        missing = "the Mamba-2 mixer's ssm_inner / ssm_heads split"
    elif any(s.attn == ATTN_MLA for s in specs):
        missing = "MLA under tensor parallelism"
    elif cfg.encoder_layers or frames is not None:
        missing = "whisper's encoder and cross-attention"
    elif patches is not None:
        missing = "paligemma's patch prefix"
    elif cfg.num_shared_experts:
        missing = "shared experts under tensor parallelism"
    elif mode == "chunk_prefill":
        missing = "chunked prefill"
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: a step under a plan over {sh.mesh.size} ranks "
            f"needs {missing}, which is not ported")


# ------------------------------------------------------------ vocabulary

def embed_lookup(sh: ShardCtx, table, ids):
    """Token embeddings from this rank's rows of the table (V_loc, E):
    the ids of other ranks' rows give 0 here, and the sum over the vocab's
    axes gives every rank the whole lookup."""
    V_loc = table.shape[0]
    v0 = sh.index_of("vocab") * V_loc
    mine = (ids >= v0) & (ids < v0 + V_loc)
    x = table[torch.clamp(ids - v0, 0, V_loc - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype))
    return C.reduce_from(x, sh.group_of("vocab"))


def vocab_logits(sh: ShardCtx, h, w):
    """This rank's columns of the f32 logits: h (..., E) replicated, w
    (E, V_loc)."""
    return torch.matmul(C.copy_to(h, sh.group_of("vocab")).float(),
                        w.float())


def gather_vocab(sh: ShardCtx, logits):
    """Whole logits from each rank's columns."""
    return C.gather_from(logits.contiguous(), sh.group_of("vocab"), -1)


def vocab_xent(sh: ShardCtx, logits, targets, mask):
    """``losses.xent`` on this rank's columns (T, V_loc) of the logits:
    logsumexp from the global max and the sum of exp, the gold logit from
    the rank whose columns hold it.  Returns (sum_loss, sum_mask) of this
    rank's rows."""
    group = sh.group_of("vocab")
    V_loc = logits.shape[-1]
    v0 = sh.index_of("vocab") * V_loc
    m = C.all_reduce(logits.detach().amax(-1),
                     group, torch.distributed.ReduceOp.MAX)
    se = C.reduce_from(torch.exp(logits - m[:, None]).sum(-1), group)
    logz = m + torch.log(se)
    t = targets.long()
    mine = (t >= v0) & (t < v0 + V_loc)
    gold = torch.gather(logits, -1,
                        torch.clamp(t - v0, 0, V_loc - 1)[:, None])[:, 0]
    gold = C.reduce_from(torch.where(mine, gold, 0.0), group)
    nll = (logz - gold) * mask
    return torch.sum(nll), torch.sum(mask)


# ------------------------------------------------------------------- FFN

def ffn_local(sh: Optional[ShardCtx], p, x, d_ff: int, body):
    """``body(p, x)`` (a dense FFN) on this rank's slice of its ``ffn``
    dim: the input enters with ``copy_to`` and the partial output leaves
    with ``reduce_from`` when ``p["wi"]`` holds fewer than ``d_ff``
    columns; a whole FFN runs as it is."""
    if sh is None or p["wi"].shape[-1] == d_ff:
        return body(p, x)
    group = sh.group_of("ffn")
    return C.reduce_from(body(p, C.copy_to(x, group)), group)
