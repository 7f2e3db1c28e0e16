"""Decode rate of one checkout's 4-layer mixtral serving paths on a CUDA card.

Imports the ``chip_smoke.py`` and ``repro_torch`` of the checkout at
``--root``, builds its kernels, and runs its ``serve`` phase (the dense
ring) and ``serve_paged`` phase (the block-paged arena), each engine
serving ``--repeats`` times the same seeded requests, then one profiled
window of each (``phase_trace``).  Prints chip_smoke's JSON lines and, as
the last line, a summary: the decode tokens/s of every run, and each
window's wall ms, busy share and device ms by kernel family.

    python3 scripts/serve_ab.py --root DIR [--repeats 3]

To compare two commits, unpack both and run the script on each in one
call, in the order parent, change, change, parent: decode rates spread
between processes on a shared host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="a checkout of this repository")
    ap.add_argument("--repeats", type=int, default=3,
                    help="serve runs of each engine")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_ab.py: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    build.build_all()

    lines = []
    emit = cs.emit

    def keep(obj):
        lines.append(obj)
        emit(obj)
    cs.emit = keep

    def rates(eng, prompt_lens, seed):
        out = []
        for _ in range(args.repeats - 1):
            _, res, _ = cs.serve_run(torch, np, eng, ops, prompt_lens,
                                     cs.N_REQUESTS, seed)
            keep({"phase": "serve_repeat", "decode_tok_per_s":
                  res["decode_tok_per_s"]})
            out.append(res["decode_tok_per_s"])
        return out

    eng, _, _, _, res = cs.phase_serve(torch, np, ops)
    serve = [res["decode_tok_per_s"]] + rates(eng, cs.PROMPT_LENS, cs.SEED)
    eng_p, _, _, res = cs.phase_serve_paged(torch, np, ops, eng.params)
    paged = [res["decode_tok_per_s"]] + rates(eng_p, cs.PAGED_PROMPT_LENS,
                                              cs.SEED + 2)
    cs.phase_trace(torch, np, eng, "dense", cs.PROMPT_LENS, 8)
    cs.phase_trace(torch, np, eng_p, "paged", cs.PAGED_PROMPT_LENS, 16)
    traces = {t["engine"]: {k: t[k] for k in ("wall_ms", "device_busy_share",
                                               "device_ms_by_family")}
              for t in lines if t.get("phase") == "trace"}
    print(json.dumps({"root": root, "serve_decode_tok_per_s": serve,
                      "serve_paged_decode_tok_per_s": paged,
                      "trace": traces}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
