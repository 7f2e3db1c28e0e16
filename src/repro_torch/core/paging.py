"""Paged weights (``repro/core/paging.py``; paper Appendix A.1, Fig. 11).

Layer weights are chunked into fixed-size *pages*; a page table maps
(layer, leaf) → page span.  Whole-layer paging (``pack_block_groups``)
packs every leaf of a layer into one span, streamed whole through the
two-slot device buffer each forward pass (CGOPipe with paged weights).
The expert-granular split
(``pack_layer_stack_split`` / ``pack_block_groups_split``) divides each
layer's manifest into a *shared* span (attention, norms, router, shared
experts: streamed every layer through a two-slot device buffer, the
``DoubleBuffer`` below) and per-(layer, expert) spans for the routed expert
weights, with a ``(layer, expert) → page ids`` table.  Top-k routing touches
only a fraction of the experts, so the engine gathers just the activated
experts' spans (``kernels.ops.expert_gather``), resident ones from the
device pool that ``core.residency`` manages and the rest straight from the
host store.

The packed pools equal the JAX package's bit for bit (pages and manifests).
The port adds one affordance: ``PagedWeights.empty`` sizes the stores of a
model from its stacked parameter shapes (tensors on the ``meta`` device
will do), and ``write_layer`` fills them one (group, layer) at a time, so
a model whose stack does not fit anywhere whole is packed layer by layer;
``pack_block_groups_split`` and ``pack_block_groups`` are that loop over
the stacked blocks.  Whole-layer paging is a ``PagedWeights`` with no
expert manifests (``split=False``).  The stores are host memory
(``core.offload.weight_store``: page-locked for a CUDA engine).

``transfer_plan``, ``window_plan`` and ``predicted_drain_order`` schedule
which pending transfer moves during which micro-batch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import offload
from repro_torch.models.common import torch_dtype


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's dtype string ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def _itemsize(name: str) -> int:
    return torch.empty((), dtype=torch_dtype(name)).element_size()


@dataclass(frozen=True)
class LeafEntry:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]       # per-layer shape (stack dim removed)
    dtype: str
    offset: int                  # element offset within the layer's flat span


@dataclass
class PageManifest:
    page_elems: int
    layer_elems: int             # padded flat elements per layer
    pages_per_layer: int
    num_layers: int
    leaves: List[LeafEntry]
    dtype: str

    def layer_pages(self, layer: int) -> np.ndarray:
        start = layer * self.pages_per_layer
        return np.arange(start, start + self.pages_per_layer)


@dataclass
class ExpertManifest:
    """Per-(layer, expert) page spans for one stacked layer group.  The
    span unit is ONE expert's weights in ONE layer — the granularity the
    residency cache pins/evicts and the router-gated gather fetches."""
    page_elems: int
    expert_elems: int            # padded flat elements per (layer, expert)
    pages_per_expert: int
    num_layers: int
    num_experts: int
    leaves: List[LeafEntry]      # paths relative to the moe subtree
    dtype: str

    def expert_pages(self, layer: int, expert: int) -> np.ndarray:
        """The (layer, expert) → page ids table (flat pool numbering)."""
        start = ((layer * self.num_experts + expert)
                 * self.pages_per_expert)
        return np.arange(start, start + self.pages_per_expert)

    @property
    def span_bytes(self) -> int:
        """H2D bytes one expert span moves (padded, what a transfer costs)."""
        return self.pages_per_expert * self.page_elems * _itemsize(self.dtype)


@dataclass
class SplitManifest:
    shared: PageManifest
    experts: Optional[ExpertManifest]


def _flatten_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


# Routed-expert leaves inside a "moe" subtree.  Shared experts and the int8
# dequant scales stay in the shared span (see the JAX module).
EXPERT_LEAF_NAMES = ("wi", "wo")


def _is_expert_leaf(path: Tuple[str, ...]) -> bool:
    return ("moe" in path and "shared" not in path
            and path[-1] in EXPERT_LEAF_NAMES)


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _entries(leaves, lead: int) -> Tuple[List[LeafEntry], int]:
    """Manifest entries of [(path, leaf)] whose first `lead` dims are the
    stack; returns (entries, packed elements per stack entry)."""
    entries, offset = [], 0
    for path, leaf in leaves:
        shape = tuple(leaf.shape[lead:])
        entries.append(LeafEntry(path, shape, _dtype_name(leaf.dtype),
                                 offset))
        offset += _numel(shape)
    return entries, offset


def _shared_manifest(leaves, page_elems: int) -> PageManifest:
    L = leaves[0][1].shape[0]
    entries, n = _entries(leaves, 1)
    ppl = math.ceil(n / page_elems)
    return PageManifest(page_elems, ppl * page_elems, ppl, L, entries,
                        _dtype_name(leaves[0][1].dtype))


def _expert_manifest(leaves, page_elems: int) -> ExpertManifest:
    L, NE = leaves[0][1].shape[:2]
    entries, n = _entries(leaves, 2)
    entries = [LeafEntry(e.path[e.path.index("moe") + 1:], e.shape, e.dtype,
                         e.offset) for e in entries]
    ppe = math.ceil(n / page_elems)
    return ExpertManifest(page_elems, ppe * page_elems, ppe, L, NE, entries,
                          _dtype_name(leaves[0][1].dtype))


def _fill(flat: torch.Tensor, entries: List[LeafEntry], leaves) -> None:
    """Write one stack entry's leaves into its flat span (1-D, contiguous)
    at their manifest offsets, cast to the span's dtype, and zero the
    padding after the last leaf."""
    end = 0
    for e, leaf in zip(entries, leaves):
        n = _numel(e.shape)
        flat[e.offset:e.offset + n].copy_(leaf.reshape(-1))
        end = e.offset + n
    flat[end:].zero_()


def pack_layer_stack(stacked: Dict, page_elems: int = 1 << 20
                     ) -> Tuple[torch.Tensor, PageManifest]:
    """stacked: tree whose every leaf has a leading `layers` dim L.
    Returns (pages (L * ppl, page_elems), manifest)."""
    leaves = _flatten_with_paths(stacked)
    m = _shared_manifest(leaves, page_elems)
    pages = torch.empty((m.num_layers, m.layer_elems),
                        dtype=torch_dtype(m.dtype))
    for layer in range(m.num_layers):
        _fill(pages[layer], m.leaves, [leaf[layer] for _, leaf in leaves])
    return pages.view(-1, page_elems), m


def pack_expert_stack(expert_leaves, page_elems: int = 1 << 20
                      ) -> Tuple[torch.Tensor, ExpertManifest]:
    """expert_leaves: [(path, tensor (L, E, ...))].  Returns
    (pages (L, E, pages_per_expert, page_elems), manifest); leaf paths are
    relative to the ``moe`` subtree."""
    em = _expert_manifest(expert_leaves, page_elems)
    pages = torch.empty((em.num_layers, em.num_experts, em.expert_elems),
                        dtype=torch_dtype(em.dtype))
    for layer in range(em.num_layers):
        for e in range(em.num_experts):
            _fill(pages[layer, e], em.leaves,
                  [leaf[layer, e] for _, leaf in expert_leaves])
    return pages.view(em.num_layers, em.num_experts, -1, page_elems), em


def pack_layer_stack_split(stacked: Dict, page_elems: int = 1 << 20
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      SplitManifest]:
    """Split one stacked layer group into a shared span and per-(layer,
    expert) spans.  Returns (shared_pages (L * ppl, page_elems),
    expert_pages (L, E, ppe, page_elems) or None, SplitManifest)."""
    leaves = _flatten_with_paths(stacked)
    expert_leaves = [(p, t) for p, t in leaves if _is_expert_leaf(p)]
    shared_leaves = [(p, t) for p, t in leaves if not _is_expert_leaf(p)]
    shared_pages, shared_manifest = pack_layer_stack(
        tree_from_leaves(shared_leaves), page_elems)
    if not expert_leaves:
        return shared_pages, None, SplitManifest(shared_manifest, None)
    expert_pages, em = pack_expert_stack(expert_leaves, page_elems)
    return shared_pages, expert_pages, SplitManifest(shared_manifest, em)


def tree_from_leaves(leaves) -> Dict:
    """A nested dict from [(path, leaf)]."""
    out: Dict = {}
    for path, leaf in leaves:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return out


def _leaf_at(tree: Dict, path):
    for p in path:
        tree = tree[p]
    return tree


@dataclass
class PagedWeights:
    """Engine-facing bundle for split (expert-granular) paging: per-group
    shared spans (L, ppl, page_elems), plus the per-(layer, expert) page
    pools and manifests for every MoE group, all in host stores.  Groups
    without routed experts appear only in ``pages`` / ``manifests``."""
    pages: Dict[str, torch.Tensor]           # key -> (L, ppl, page_elems)
    manifests: Dict[str, PageManifest]
    expert_pages: Dict[str, torch.Tensor]    # key -> (L, E, ppe, page_elems)
    expert_manifests: Dict[str, ExpertManifest]

    def shared_layer_bytes(self, key: str) -> int:
        m = self.manifests[key]
        return m.pages_per_layer * m.page_elems * _itemsize(m.dtype)

    @classmethod
    def empty(cls, blocks: Dict, page_elems: int, device, *,
              split: bool = True) -> "PagedWeights":
        """Manifests and unfilled host stores for a model's stacked block
        params (``{key: tree of (L, ...) tensors}``; only shapes and dtypes
        are read, so ``meta`` tensors do), for an engine on `device`.
        ``split=False``: whole-layer spans, every leaf in ``pages`` (the
        reference's ``pack_layer_stack`` layout) and no expert spans."""
        device = torch.device(device)
        pw = cls({}, {}, {}, {})
        for key, group in blocks.items():
            leaves = _flatten_with_paths(group)
            shared = [(p, t) for p, t in leaves
                      if not (split and _is_expert_leaf(p))]
            experts = [(p, t) for p, t in leaves
                       if split and _is_expert_leaf(p)]
            m = _shared_manifest(shared, page_elems)
            pw.manifests[key] = m
            pw.pages[key] = offload.weight_store(
                (m.num_layers, m.pages_per_layer, page_elems),
                torch_dtype(m.dtype), device)
            if experts:
                em = _expert_manifest(experts, page_elems)
                pw.expert_manifests[key] = em
                pw.expert_pages[key] = offload.weight_store(
                    (em.num_layers, em.num_experts, em.pages_per_expert,
                     page_elems), torch_dtype(em.dtype), device)
        return pw

    def write_layer(self, key: str, layer: int, tree: Dict) -> None:
        """Pack one layer of group `key` into the stores: `tree` holds that
        layer's leaves (per-layer shapes, the stack dim removed) on any
        device.  Every (key, layer) must be written once before use."""
        m = self.manifests[key]
        _fill(self.pages[key][layer].view(-1), m.leaves,
              [_leaf_at(tree, e.path) for e in m.leaves])
        em = self.expert_manifests.get(key)
        if em is None:
            return
        moe = tree["moe"]
        for e in range(em.num_experts):
            _fill(self.expert_pages[key][layer, e].view(-1), em.leaves,
                  [_leaf_at(moe, le.path)[e] for le in em.leaves])

    def release(self) -> None:
        """Unpin the stores (``core.offload.release``)."""
        for t in (*self.pages.values(), *self.expert_pages.values()):
            offload.release(t)


def pack_block_groups_split(blocks: Dict, page_elems: int = 1 << 20,
                            device="cpu") -> PagedWeights:
    """Split-pack every period-position group of a model's stacked block
    params into host stores for an engine on `device`, one layer at a
    time (``PagedWeights.write_layer``)."""
    pw = PagedWeights.empty(blocks, page_elems, device)
    for key, group in blocks.items():
        for layer in range(pw.manifests[key].num_layers):
            pw.write_layer(key, layer, layer_slice(group, layer))
    return pw


def pack_block_groups(blocks: Dict, page_elems: int = 1 << 20,
                      device="cpu") -> PagedWeights:
    """Whole-layer-pack every period-position group of a model's stacked
    block params into host stores for an engine on `device`: pages[key] is
    (L, pages_per_layer, page_elems), as the reference's
    ``pack_block_groups`` returns it, and there are no expert spans."""
    pw = PagedWeights.empty(blocks, page_elems, device, split=False)
    for key, group in blocks.items():
        for layer in range(pw.manifests[key].num_layers):
            pw.write_layer(key, layer, layer_slice(group, layer))
    return pw


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer i of a stacked tree (views)."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _unflatten(flat: torch.Tensor, leaves: List[LeafEntry], lead=()) -> Dict:
    out: Dict = {}
    for e in leaves:
        n = _numel(e.shape)
        leaf = flat[..., e.offset:e.offset + n].reshape(lead + e.shape)
        node = out
        for p in e.path[:-1]:
            node = node.setdefault(p, {})
        node[e.path[-1]] = leaf
    return out


def unflatten_span(span: torch.Tensor, manifest: PageManifest) -> Dict:
    """Rebuild one layer's parameter tree from its page span
    (pages_per_layer, page_elems): views at static offsets."""
    return _unflatten(span.reshape(-1), manifest.leaves)


def unflatten_expert_span(span: torch.Tensor, em: ExpertManifest) -> Dict:
    """Rebuild expert params from page spans with arbitrary leading batch
    dims: span (..., pages_per_expert, page_elems) -> tree whose leaves
    have shape (..., *leaf_shape) — the compacted (A, ...) expert subset
    the two-phase MoE step computes on."""
    lead = tuple(span.shape[:-2])
    return _unflatten(span.reshape(lead + (-1,)), em.leaves, lead)


# ---------------------------------------------------------------------------
# Transfer scheduling (which page moves during which micro-batch)
# ---------------------------------------------------------------------------

def transfer_plan(pages_per_layer: int, n_ubs: int) -> List[List[int]]:
    """Split a layer's pages into n_ubs groups; group j is transferred
    while micro-batch j computes (CGOPipe interleaving: the small, urgent
    hidden-state transfer for ub j+1 slots between groups)."""
    groups: List[List[int]] = [[] for _ in range(n_ubs)]
    for p in range(pages_per_layer):
        groups[p * n_ubs // pages_per_layer].append(p)
    return groups


def window_plan(n_items: int, n_ubs: int,
                positions: Sequence[int]) -> List[int]:
    """The union of the transfer_plan groups for every rotation position
    in `positions` (taken mod n_ubs); returns sorted item ids."""
    plan = transfer_plan(n_items, n_ubs)
    return sorted({i for p in positions for i in plan[p % n_ubs]})


def predicted_drain_order(pairs: Sequence[Tuple[int, int]],
                          scores: Sequence[float]) -> List[int]:
    """Earliest-deadline-first enqueue order for gate-predicted expert
    spans: a span predicted for layer l is only useful if it lands before
    the layer-l step consumes it, so shallow layers enqueue first (ties
    broken toward higher predicted probability).  Returns indices into
    ``pairs``."""
    return sorted(range(len(pairs)),
                  key=lambda i: (pairs[i][0], -scores[i], pairs[i][1]))


@dataclass
class DoubleBuffer:
    """The 2×W_L weight buffer of Appendix A.1: layer i computes out of
    slot i % 2 while layer i+1's span streams into the other
    (``models.model`` runs it with a copy stream and events)."""
    n_slots: int = 2
    resident: List[int] = field(default_factory=lambda: [-1, -1])

    def slot_for(self, layer: int) -> int:
        return layer % self.n_slots

    def load(self, layer: int) -> int:
        s = self.slot_for(layer)
        self.resident[s] = layer
        return s

    def is_resident(self, layer: int) -> bool:
        return self.resident[self.slot_for(layer)] == layer
