"""Training launcher of the PyTorch port (``repro/launch/train.py``, plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch mixtral-8x7b --smoke --steps 20 [--device cpu]

It runs on the card unless ``--device`` names another device.  The
Trainer resumes from the latest checkpoint in ``--ckpt-dir``, so
preemption recovery is: re-run the same command.  Under a launcher that
sets ``RANK`` and ``WORLD_SIZE`` (``torchrun``) every process joins the
launcher's process group first (``init_distributed``).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from repro_torch.device import DeviceLike, resolve_device


def init_distributed(device: DeviceLike = None) -> Optional[str]:
    """Join the launcher's process group when ``RANK`` and ``WORLD_SIZE``
    are set (its rendezvous from ``MASTER_ADDR`` / ``MASTER_PORT``): nccl
    on the card, gloo only when the caller asks for the CPU.  Returns the
    backend, or None when no launcher set the variables."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    import torch
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend)
    return backend


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config for CPU")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--num-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    backend = init_distributed(args.device)

    from repro_torch.configs import get_config
    from repro_torch.training.trainer import Trainer, TrainConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                       num_micro=args.num_micro, seed=args.seed)
    trainer = Trainer(cfg, tcfg, device=args.device)
    metrics = trainer.run()
    out = {"final": metrics, "log": trainer.metrics_log[-5:]}
    if backend is not None:
        import torch.distributed as dist
        out["process_group"] = {"backend": backend,
                                "rank": dist.get_rank(),
                                "world_size": dist.get_world_size()}
        dist.destroy_process_group()
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
