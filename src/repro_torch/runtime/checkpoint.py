"""Checkpointing (``repro/runtime/checkpoint.py``), with the reference's
on-disk layout, so either package restores the other's checkpoints.

Layout: <dir>/step_<N>/
  manifest.json     — leaf paths, shapes, dtypes, step, extra metadata
  <leaf-path>.npy   — one file per leaf

Guarantees:
  * atomic:  written to step_<N>.tmp then os.rename'd — a crash mid-write
    never corrupts the latest checkpoint;
  * async:   ``save_async`` snapshots every leaf into a host copy of its
    own at once (``.detach().cpu().clone()``: on the CPU ``.numpy()``
    shares memory with the parameter, which the next in-place update
    rewrites) and writes on a background thread — training continues.

bfloat16 leaves are written as their uint16 bits under the dtype name
"bfloat16", as the reference writes them, and restored by reinterpreting
those bits (``torch.bfloat16``), so no ``ml_dtypes`` is needed.
``restore(device=)`` puts every leaf on one device; a sharded restore
belongs to the distributed slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _unflatten(items):
    root: Dict = {}
    for path, val in items:
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = val
    return root


def _leaf_file(path: Tuple[str, ...]) -> str:
    return "__".join(path) + ".npy"


def _host(v, copy: bool) -> Tuple[np.ndarray, str]:
    """(array to write, dtype name) of one tensor leaf; bf16 as its uint16
    bits."""
    t = v.detach().cpu()
    if copy:
        t = t.clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Dict, extra: Optional[Dict] = None):
        self.wait()                      # never race a pending async writer
        snap = [(p, *_host(v, copy=False)) for p, v in _flatten(tree)]
        self._write(step, snap, extra or {})

    def save_async(self, step: int, tree: Dict, extra: Optional[Dict] = None):
        self.wait()                      # one writer at a time
        snap = [(p, *_host(v, copy=True)) for p, v in _flatten(tree)]
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, extra or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, snap: List, extra: Dict):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for path, arr, dtype_name in snap:
            fn = _leaf_file(path)
            np.save(tmp / fn, arr)
            manifest["leaves"].append({"path": list(path), "file": fn,
                                       "shape": list(arr.shape),
                                       "dtype": dtype_name})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in self.dir.glob("step_*"):
            if d.is_dir() and not d.name.endswith(".tmp") and \
                    (d / "manifest.json").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device: DeviceLike = None
                ) -> Tuple[int, Dict, Dict]:
        """Returns (step, tree, extra), the tree's leaves torch tensors on
        ``device`` (the CPU when None)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        items = []
        for leaf in manifest["leaves"]:
            arr = np.load(d / leaf["file"])
            want = leaf["dtype"]
            if want == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            elif str(arr.dtype) == want:
                t = torch.from_numpy(arr)
            else:
                raise TypeError(f"{leaf['file']}: dtype {want} is not one "
                                f"the port restores")
            if device is not None:
                t = t.to(device)
            items.append((tuple(leaf["path"]), t))
        return step, _unflatten(items), manifest["extra"]
