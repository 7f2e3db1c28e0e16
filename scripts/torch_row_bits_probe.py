#!/usr/bin/env python3
"""Does a row's result depend on how many rows share the call?

Module-based batching decodes a window of G rotation groups through one
forward, and its greedy transcripts equal lockstep's only where every
row-wise operation gives a row the same bits at G·ubatch rows as at
ubatch rows.  This probe counts, on the card, the elements that differ
between one call over 2·n rows and two calls over n rows each, at
mixtral-8x7b's width in bf16 (decode shapes, (rows, 1, d_model)):

  * ``rmsnorm``: the port's ``apply_norm``;
  * ``matmul_bf16``: x @ W with W (4096, 4096) bf16, as an attention
    projection;
  * ``matmul_f32_lm_head``: x.float() @ W.float() with W (4096, 32000),
    as ``unembed``.

Run from the repository root on a CUDA machine:

    python3 scripts/torch_row_bits_probe.py [--trials 200]

Prints one JSON line: for each operation and each n, [differing
elements, elements compared].
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("mixtral-8x7b")
    g = torch.Generator(device="cuda").manual_seed(0)
    d = cfg.d_model
    scale = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(
        torch.bfloat16)
    w = (torch.randn(d, d, generator=g, device="cuda") / d ** 0.5).to(
        torch.bfloat16)
    head = (torch.randn(d, cfg.vocab_size, generator=g, device="cuda")
            / d ** 0.5).to(torch.bfloat16).float()
    ops = {"rmsnorm": lambda x: apply_norm(cfg, {"scale": scale}, x),
           "matmul_bf16": lambda x: torch.matmul(x, w),
           "matmul_f32_lm_head": lambda x: torch.matmul(x.float(), head)}
    out = {}
    for name, fn in ops.items():
        out[name] = {}
        for n in (8, 12, 16, 32):
            bad = total = 0
            for _ in range(args.trials):
                x = (3 * torch.randn(2 * n, 1, d, generator=g,
                                     device="cuda")).to(torch.bfloat16)
                whole = fn(x)
                halves = torch.cat([fn(x[:n]), fn(x[n:])])
                bad += int((whole != halves).sum())
                total += whole.numel()
            out[name][f"{2 * n}_vs_2x{n}"] = [bad, total]
    print(json.dumps({"probe": "row_bits", "trials": args.trials,
                      "device": torch.cuda.get_device_name(0), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
