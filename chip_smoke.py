#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. build   — compile the three CUDA kernels from ``src/repro_torch/kernels/
               csrc`` (one nvcc per source, all at once) and time it.
  2. kernels — hold each kernel against its plain PyTorch version on the card:
               in float32 at small shapes (TF32 off) and in bf16 at the
               shapes the served model gives it; time the kernel, its plain
               version and one PyTorch library call beside the least time
               the card could take (``bound_ms``).
  3. serve   — the port's Engine at the full width of mixtral-8x7b with the
               depth cut from 32 to 4 layers (all 32 layers of bf16 weights,
               ~93 GB, exceed the card's 80 GB; the offloading path that
               serves them is a later slice), random weights from a seed:
               24 requests of 32..384 prompt tokens and 64 new tokens each,
               with every kernel's launches counted over the run.
  4. trace   — a separate serving window under torch.profiler: device
               time by kernel family and the device's busy share.
  5. check   — prefill and decode logits of two prompts through the kernels
               against the same forward through the plain versions
               (``ExecPolicy(impl="ref")``), and how far their greedy
               transcripts agree.

Then a ``{"kernels": [...]}`` line, the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; so does a machine without a CUDA device, and a copy of
this file outside the repository.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
LAYERS = 4                    # of mixtral-8x7b's 32
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak, 700 W
SERVE = dict(ubatch=8, num_ubs=2, max_seq=512, decode_chunk=8)
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 24, (32, 384), 64
# bf16 tolerances.  A kernel and its plain version both compute in f32 from
# the same bf16 inputs; an output rounded to bf16 may then differ by one
# bf16 ulp (2^-8 relative) where the two f32 sums straddle a rounding edge.
BF16_OUT_TOL = 1e-2
# f32 partials (gqa_decode) and f32 runs differ only in summation order.
F32_TOL = 1e-4
# Served logits: the kernel and plain paths round the same activations to
# bf16 at different points of 4 layers; one-ulp differences (~0.4 %) carried
# through residual adds and norms stay within this on O(1) logits.
LOGIT_TOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of one call, by CUDA events.  Before each call the
    stream sleeps (so the host's enqueue cost is hidden) and a 64 MB buffer
    is rewritten (so the 50 MB L2 is cold, as on the served path, where the
    expert weights stream through it between calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(1_000_000)
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / BF16_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def sdpa_gqa(F, q, k, v, group: int, **kw):
    """One scaled_dot_product_attention call over (B, H, S, D) heads,
    grouped-query natively where this PyTorch has ``enable_gqa`` (2.5+);
    older versions get K/V expanded to H heads beforehand."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, tol: float) -> bool:
    """|a - b| <= tol + tol * |b| everywhere."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def phase_kernels(torch, F):
    """Returns the per-kernel records of the kernels line (launches are
    filled in by the serve phase)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.moe_ffn import moe_ffn
    g = torch.Generator(device=DEVICE).manual_seed(SEED)

    def rn(*shape, std=1.0, dtype=torch.bfloat16):
        t = torch.empty(shape, dtype=dtype, device=DEVICE)
        return t.normal_(0.0, std, generator=g)

    # --- float32 at small shapes, TF32 off: the algorithm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    x, wi, wo = (rn(4, 10, 64, dtype=f32), rn(4, 64, 2, 300, std=0.1,
                 dtype=f32), rn(4, 300, 64, std=0.1, dtype=f32))
    si = torch.rand(4, generator=g, device=DEVICE) + 0.5
    pairs = {"moe_ffn": [(moe_ffn(x, wi, wo, si, si, act="gelu"),
                          ref.moe_ffn_ref(x, wi, wo, si, si, act="gelu"))]}
    q, k, v = rn(3, 8, 64, dtype=f32), rn(3, 100, 2, 64, dtype=f32), \
        rn(3, 100, 2, 64, dtype=f32)
    valid = torch.rand(3, 100, generator=g, device=DEVICE) > 0.3
    valid[1] = False                        # a row with no valid slot
    pairs["gqa_decode"] = list(zip(
        gqa_decode(q, k, v, valid, scale=0.125, attn_softcap=30.0),
        ref.gqa_decode_ref(q, k, v, valid, scale=0.125, attn_softcap=30.0)))
    q, k, v = rn(2, 70, 4, 32, dtype=f32), rn(2, 70, 2, 32, dtype=f32), \
        rn(2, 70, 2, 32, dtype=f32)
    pairs["flash_prefill"] = [
        (flash_prefill(q, k, v, window=w, attn_softcap=c),
         ref.flash_prefill_ref(q, k, v, window=w, attn_softcap=c))
        for w, c in ((0, 0.0), (16, 30.0))]
    torch.cuda.synchronize()
    errs = {n: max(max_err(a, b) for a, b in ps) for n, ps in pairs.items()}
    emit({"phase": "kernels_f32", "max_abs_err": errs, "tol": F32_TOL})
    require(all(close(a, b, F32_TOL) for ps in pairs.values()
                for a, b in ps), f"f32 kernel mismatch: {errs}")

    # --- bf16 at the served shapes: the kernels as the main path runs them
    timer = Timer(torch)
    n = 256 << 20                                # HBM copy rate, 2 x 512 MB
    a = torch.empty(n, dtype=f32, device=DEVICE)
    b = torch.empty_like(a)
    copy_ms = timer(lambda: b.copy_(a))
    emit({"phase": "hbm_copy", "bytes": 2 * 4 * n, "ms": copy_ms,
          "GBps": 2 * 4 * n / copy_ms / 1e6})
    del a, b

    cfg_full = _mixtral()
    E, D, Fd = cfg_full.num_experts, cfg_full.d_model, cfg_full.d_ff
    H, Hkv, Dh = cfg_full.num_heads, cfg_full.num_kv_heads, cfg_full.head_dim
    B, W = SERVE["ubatch"], SERVE["max_seq"]
    records = []

    # moe_ffn at the decode bucket (the most launched shape) and at the
    # largest prefill bucket
    wi = rn(E, D, 2, Fd, std=D ** -0.5)
    wo = rn(E, Fd, D, std=Fd ** -0.5)
    for tokens, label in ((B, "decode"), (PROMPT_LENS[1], "prefill")):
        C = max(1, int(tokens * cfg_full.top_k * cfg_full.capacity_factor
                       / E + 0.999))
        x = rn(E, C, D)
        got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
        err = max_err(got, want)
        require(close(got, want, BF16_OUT_TOL), f"moe_ffn bf16 {label}: {err}")
        wi3 = wi.view(E, D, 2 * Fd)

        def library():
            h = torch.bmm(x, wi3)
            return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
        nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)
        bms, by = bound(nbytes, 6 * E * C * D * Fd)
        rec = {"name": "moe_ffn", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
               "replaces": "src/repro/kernels/moe_ffn.py:59",
               "shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                         "at": label},
               "max_abs_err": err,
               "ms": timer(lambda: moe_ffn(x, wi, wo)),
               "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(library)}
        emit({"phase": "kernel_bf16", **rec})
        if label == "decode":
            records.append(rec)
    del wi, wo, x

    # gqa_decode over a half-filled 512-slot ring, as mid-serve
    q, k, v = rn(B, H, Dh), rn(B, W, Hkv, Dh), rn(B, W, Hkv, Dh)
    lens = torch.randint(PROMPT_LENS[0], PROMPT_LENS[1] + NEW_TOKENS,
                         (B,), generator=g, device=DEVICE)
    valid = torch.arange(W, device=DEVICE)[None, :] < lens[:, None]
    kw = dict(scale=Dh ** -0.5)
    got, want = gqa_decode(q, k, v, valid, **kw), \
        ref.gqa_decode_ref(q, k, v, valid, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"gqa_decode bf16: {err}")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    # q, the K and V rows of the valid slots only (the rest are never
    # needed), the mask, and the f32 (o_unnorm, m, l) outputs
    nvalid = int(valid.sum())
    nbytes = 2 * B * H * Dh + 2 * nvalid * Hkv * 2 * Dh + B * W \
        + 4 * B * H * (Dh + 2)
    bms, by = bound(nbytes, 2 * nvalid * H * 2 * Dh)
    rec = {"name": "gqa_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/gqa_decode.cu",
           "replaces": "src/repro/kernels/gqa_decode.py:85",
           "shape": {"B": B, "H": H, "Hkv": Hkv, "D": Dh, "W": W,
                     "valid": nvalid, "dtype": "bf16"},
           "max_abs_err": err,
           "ms": timer(lambda: gqa_decode(q, k, v, valid, **kw)),
           "plain_ms": timer(lambda: ref.gqa_decode_ref(q, k, v, valid, **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(
               F, q[:, :, None], kt, vt, H // Hkv,
               attn_mask=valid[:, None, None, :]))}
    emit({"phase": "kernel_bf16", **rec})
    records.append(rec)

    # flash_prefill on the largest prompt bucket
    S = PROMPT_LENS[1]
    q, k, v = rn(1, S, H, Dh), rn(1, S, Hkv, Dh), rn(1, S, Hkv, Dh)
    got, want = flash_prefill(q, k, v), ref.flash_prefill_ref(q, k, v)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL), f"flash_prefill bf16: {err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    causal_pairs = S * (S + 1) // 2           # (query, key) pairs computed
    nbytes = 2 * (2 * S * H * Dh + 2 * S * Hkv * Dh)
    bms, by = bound(nbytes, 2 * causal_pairs * H * 2 * Dh)
    rec = {"name": "flash_prefill", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
           "replaces": "src/repro/kernels/flash_prefill.py:73",
           "shape": {"B": 1, "S": S, "H": H, "Hkv": Hkv, "D": Dh,
                     "dtype": "bf16"},
           "max_abs_err": err,
           "ms": timer(lambda: flash_prefill(q, k, v)),
           "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, qt, kt, vt, H // Hkv,
                                        is_causal=True))}
    emit({"phase": "kernel_bf16", **rec})
    records.append(rec)
    return records


def _mixtral():
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b")


def phase_serve(torch, np, ops):
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(**SERVE),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    prefill_s = [0.0]
    inner = eng._prefill

    def timed_prefill(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return out
    eng._prefill = timed_prefill

    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in lens]
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    reqs = [eng.scheduler.requests[r] for r in rids]
    require(all(r.done and not r.aborted for r in reqs),
            "not every request finished")
    for r in reqs:
        toks = out[r.rid]
        require(len(toks) == NEW_TOKENS or (toks and toks[-1] == 1),
                f"request {r.rid}: {len(toks)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in toks),
                f"request {r.rid}: token out of range")
    decode_s = wall - prefill_s[0]
    emit({"phase": "serve", "model": "mixtral-8x7b", "layers": LAYERS,
          "of_layers": _mixtral().num_layers, "params": count_params(cfg),
          "engine": SERVE, "requests": N_REQUESTS,
          "prompt_tokens": int(lens.sum()), "new_tokens_each": NEW_TOKENS,
          "decode_tokens": eng.tokens_out, "engine_steps": eng.steps,
          "wall_s": wall, "prefill_s": prefill_s[0], "decode_s": decode_s,
          "decode_tok_per_s": eng.tokens_out / decode_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    return eng, prompts[:2], launches


def phase_trace(torch, np, eng):
    """A separate, profiled serving window on the same engine (8 more
    requests): device time by kernel family and the device's busy share
    of the window's wall time, profiler on.  The serve phase's numbers are
    taken with the profiler off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, 8):
        eng.submit(rng.integers(2, eng.cfg.vocab_size, n), NEW_TOKENS // 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    families = {"moe_ffn": ("moe_up", "moe_down", "moe_reduce"),
                "gqa_decode": ("gqa_chunk", "gqa_combine"),
                "flash_prefill": ("flash_prefill",),
                "matmul": ("gemm", "nvjet", "xmma", "cutlass", "splitk")}
    ms = {k: 0.0 for k in (*families, "other")}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        fam = next((f for f, keys in families.items()
                    if any(k in ev.key for k in keys)), "other")
        ms[fam] += ev.self_device_time_total / 1e3
    device_ms = sum(ms.values())
    emit({"phase": "trace", "requests": 8, "new_tokens_each": NEW_TOKENS // 2,
          "wall_ms": wall * 1e3, "device_ms": device_ms,
          "device_busy_share": device_ms / (wall * 1e3),
          "device_ms_by_family": ms})


def phase_check(torch, cfg, params, prompts):
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.serving import steps

    worst = {"prefill": 0.0, "decode": 0.0}
    agree, total = 0, 0
    for prompt in prompts:
        outs = {}
        for impl in ("auto", "ref"):
            pol = ExecPolicy(moe_impl="grouped", use_kernels=True, impl=impl)
            cache = kvcache.init_cache(cfg, 1, SERVE["max_seq"],
                                       device=DEVICE)
            tok = torch.as_tensor(prompt[None].astype("int32"),
                                  device=DEVICE)
            lens = torch.tensor([len(prompt)], dtype=torch.int32,
                                device=DEVICE)
            logits, cache = steps.make_prefill_fill_step(cfg, pol)(
                params, tok, cache, lens)
            outs[impl] = {"prefill": logits, "cache": cache, "pol": pol}
        # one decode step, both paths fed the kernel path's greedy token
        first = torch.argmax(outs["auto"]["prefill"], -1).to(
            torch.int32)[:, None]
        for impl, o in outs.items():
            fwd = forward(cfg, params, first, cache=o["cache"], mode="decode",
                          policy=o["pol"])
            o["decode"] = unembed(cfg, params, fwd["hidden"][:, -1])
        for key in worst:
            a, b = outs["auto"][key], outs["ref"][key]
            require(bool(torch.isfinite(a).all()) and a.shape == b.shape
                    == (1, cfg.vocab_size), f"bad {key} logits")
            worst[key] = max(worst[key], max_err(a, b))
        # greedy transcripts of 16 tokens from each path's own caches
        seqs = {}
        for impl, o in outs.items():
            tok = torch.argmax(o["decode"], -1).to(torch.int32)[:, None]
            chunk = steps.make_decode_chunk(cfg, o["pol"], eos_id=-1,
                                            chunk=16)
            _, _, _, _, toks, _ = chunk(
                params, o["cache"], tok,
                torch.ones(1, dtype=torch.bool, device=DEVICE),
                torch.full((1,), 16, dtype=torch.int32, device=DEVICE))
            seqs[impl] = toks[:, 0].tolist()
        agree += sum(a == b for a, b in zip(seqs["auto"], seqs["ref"]))
        total += len(seqs["auto"])
    emit({"phase": "check", "prompts": len(prompts),
          "max_abs_logit_diff": worst, "tol": LOGIT_TOL,
          "greedy_agree": agree, "greedy_total": total})
    require(all(v <= LOGIT_TOL for v in worst.values()),
            f"kernel path logits differ from the plain path: {worst}")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    records = phase_kernels(torch, F)
    torch.cuda.empty_cache()
    eng, prompts, launches = phase_serve(torch, np, ops)
    phase_trace(torch, np, eng)
    phase_check(torch, eng.cfg, eng.params, prompts)

    for rec in records:
        rec["launches"] = launches[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    emit({"kernels": [{k: r[k] for k in keys} for r in records]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
