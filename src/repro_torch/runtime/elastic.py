"""Elastic re-scaling: resume any checkpoint on a different mesh
(``repro/runtime/elastic.py``).

A checkpoint holds whole leaves, whatever mesh wrote it; re-scaling is
re-sharding: build the sharding plan for the NEW mesh and keep this
rank's slice of every leaf under it.  It works for grow and shrink; where
a mesh's axis sizes do not divide a dim, ``sharding.spec_for_axes``
replicates it, so restore never fails — it only holds more per rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime.checkpoint import CheckpointManager


def restore_elastic(ckpt: CheckpointManager, cfg: ModelConfig,
                    shape: ShapeConfig, mesh: Mesh,
                    step: Optional[int] = None, device: DeviceLike = None
                    ) -> Tuple[int, Dict, Dict, SH.Plan]:
    """(step, tree, extra, plan): the checkpoint's params (and optimizer
    moments) as this rank's slices under the plan for ``mesh``, on
    ``device`` (the CPU when None); other entries of the tree whole."""
    plan = SH.make_plan(cfg, shape, mesh)
    step_, tree, extra = ckpt.restore(step=step)
    specs = {"params": plan.param_specs}
    if "opt_state" in tree:
        specs["opt_state"] = {"mu": plan.param_specs, "nu": plan.param_specs,
                              "step": SH.Spec()}
    out = {k: (SH.shard_tree(v, specs[k], mesh) if k in specs else v)
           for k, v in tree.items()}
    # copies of the slices, so the whole leaves are freed
    return step_, _copy_to(out, device or "cpu"), extra, plan


def _copy_to(tree, device):
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)
