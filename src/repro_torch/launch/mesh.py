"""Device meshes of the PyTorch port (``repro/launch/mesh.py``).

A ``Mesh`` names the axes of a grid of ranks (``("data", "model")``,
``("pod", "data", "model")``), their sizes, and, over a live
``torch.distributed`` process group, this rank's coordinates and one
process group per axis or tuple of axes, built when first asked for.
Ranks lie on the grid in row-major order, as JAX lays devices on a mesh, so
the combined index of a rank over a tuple of axes in mesh order is its rank
within that tuple's group.

A mesh made without a process group (``Mesh(shape, names)``) holds names
and sizes only: sharding plans and the census are computed for it (the
production meshes of 256 and 512 chips need no 256 processes), and asking
it for a group raises.

``make_production_mesh`` is a function, so importing this module touches
no device and no process group.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Sequence[str]]


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    if not axes:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Axis names and sizes; with ``rank``, a rank of a live process group
    whose world is the whole mesh."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 rank: Optional[int] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self._groups: Dict[Tuple[str, ...], object] = {}
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is off a mesh of {self.size}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (row-major)."""
        self._need_rank()
        out, r = {}, self.rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return dict((a, out[a]) for a in self.axis_names)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _as_tuple(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's combined index over ``axes``, major to minor in the
        order given (``jax.lax.axis_index`` over a tuple)."""
        c, idx = self.coords, 0
        for a in _as_tuple(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def in_mesh_order(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` sorted into the mesh's order."""
        axes = _as_tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes``.  Every rank asks for the same tuples in
        the same order (the local bodies are SPMD), as ``new_group``
        needs.  A group's ranks are sorted, so a rank's place in it is its
        combined index over ``axes`` in mesh order."""
        import torch.distributed as dist
        self._need_rank()
        key = self.in_mesh_order(axes)
        if key in self._groups:
            return self._groups[key]
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} over a world of "
                             f"{dist.get_world_size()}")
        if self.axis_size(key) == self.size:
            self._groups[key] = dist.group.WORLD
            return dist.group.WORLD
        others = [a for a in self.axis_names if a not in key]
        strides = {a: math.prod(self.shape[b] for b in
                                self.axis_names[i + 1:])
                   for i, a in enumerate(self.axis_names)}
        mine = None
        for off in itertools.product(*(range(self.shape[a]) for a in others)):
            base = sum(strides[a] * i for a, i in zip(others, off))
            ranks = [base + sum(strides[a] * i for a, i in zip(key, on))
                     for on in itertools.product(*(range(self.shape[a])
                                                   for a in key))]
            g = dist.new_group(sorted(ranks))
            if self.rank in ranks:
                mine = g
        self._groups[key] = mine
        return mine

    def _need_rank(self) -> None:
        if self.rank is None:
            raise RuntimeError("this mesh holds names and sizes only: make "
                               "it with make_mesh over a process group")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the live default process group, whose world size must
    be the mesh's size; this process is its rank ``dist.get_rank()``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed to be "
                           "initialized (launch.train.init_distributed)")
    mesh = Mesh(shape, axis_names, rank=dist.get_rank())
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a {tuple(shape)} mesh over a world of "
                         f"{dist.get_world_size()}")
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips ("data", "model").  Multi-pod:
    2 x 16 x 16 = 512 chips ("pod", "data", "model"); "pod" is pure data
    parallelism.  Names and sizes only."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_debug_mesh(model: int = 2, data: int = 2, pod: int = 0) -> Mesh:
    """A small mesh over the live process group (its world size must be
    pod x data x model), for tests run in several processes."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
