"""Serving launcher of the PyTorch port: offloading-aware batch inference
(the paper's workload).  Prints HRM policy advice for the full model on the
requested hardware, then runs the engine on synthetic requests and reports
generation throughput as one JSON line.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --smoke --requests 16 --hw h100 [--paged] [--device cpu]

The port of ``repro/launch/serve.py``: ``--paged`` streams the blocks'
weights whole-layer from page-locked host stores.  It runs on the card
unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--hw", default="l4",
                    help="HRM hardware preset for policy advice")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--ubatch", type=int, default=4)
    ap.add_argument("--num-ubs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import hrm, policy as pol
    from repro_torch.device import resolve_device
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    device = resolve_device(args.device)
    cfg_full = get_config(args.arch)
    # HRM policy advice is computed for the FULL model on the target hw
    hw = hrm.preset(args.hw)
    wl = pol.Workload(prompt_len=args.prompt_len, gen_len=args.gen_len)
    try:
        advice = pol.search(cfg_full, hw, wl)["best"]
        print("[serve] HRM policy advice for", args.hw, ":",
              advice["policy"], f"est {advice['throughput']:.1f} tok/s")
    except RuntimeError as e:
        print("[serve] HRM policy:", e)

    cfg = cfg_full.smoke() if args.smoke else cfg_full
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    eng = Engine(cfg, params, EngineConfig(
        ubatch=args.ubatch, num_ubs=args.num_ubs,
        max_seq=args.prompt_len + args.gen_len + 8, paged=args.paged),
        ExecPolicy(moe_impl="grouped", use_kernels=True), device=device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        n = int(rng.integers(4, args.prompt_len + 1))
        eng.submit(rng.integers(2, cfg.vocab_size, n), args.gen_len)
    t0 = time.time()
    out = eng.run_until_idle()
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    res = {"requests": len(out),
           "done": sum(r.done and not r.aborted
                       for r in eng.scheduler.requests.values()),
           "tokens": total, "seconds": round(dt, 2),
           "tok_per_s": round(total / dt, 2), "paged": args.paged,
           "device": str(device)}
    print(json.dumps(res), flush=True)
    if eng.paged_blocks is not None:
        eng.paged_blocks.release()
    return res


if __name__ == "__main__":
    main()
