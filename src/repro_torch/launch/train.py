"""Training launcher of the PyTorch port (``repro/launch/train.py``, plus
``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch mixtral-8x7b --smoke --steps 20 [--device cpu]

It runs on the card unless ``--device`` names another device.  The
Trainer resumes from the latest checkpoint in ``--ckpt-dir``, so
preemption recovery is: re-run the same command.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


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
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
