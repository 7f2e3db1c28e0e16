#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:

  1. build       — compile the six CUDA kernels from ``src/repro_torch/
                   kernels/csrc`` (one nvcc per source, all at once), timed.
  2. kernels     — hold each kernel against its plain PyTorch version on the
                   card: in float32 at small shapes (TF32 off) and in bf16
                   at the shapes the served models give it (mixtral's, and
                   DeepSeek-V3's for moe_ffn, flash_prefill and the MLA
                   decode; moe_ffn's decode bucket both full and as 8
                   routed rows fill it, its empty rows exactly zero;
                   gqa_decode's ring both half-filled, as mid-serve, and
                   full);
                   time the kernel, its plain version and one
                   PyTorch library call beside the least time the card
                   could take (``bound_ms``).  The paged decodes read an
                   arena whose trash block is NaN, and their fused forms
                   must equal write-then-attend bit for bit.  The expert
                   gather (mixtral's 352 MB spans at 0, 4 and 8 misses,
                   with a pad slot at 4) must equal its plain version bit
                   for bit; beside it the pinned host-to-device copy rate
                   (``h2d_copy``) and the route through PyTorch calls.
  3. serve       — the port's Engine at the full width of mixtral-8x7b with
                   the depth cut from 32 to 4 layers and every weight on
                   the card, random weights from a seed, the dense KV
                   ring: 24 requests of 32..384 prompt tokens and 64 new
                   tokens each.
  4. serve_paged — the same weights through the block-paged KV pool with a
                   pinned host tier, the arena sized at r_c 0.4 of the slot
                   pool: 24 requests of 128..640 prompt tokens, so that
                   blocks spill to the host tier, come back on demand and
                   are prefetched.  Each serve phase counts every kernel's
                   launches over its own run.
     serve_module — ``serve`` with module-based batching: both rotation
                   groups decode through one dispatch a window, the MoE
                   layers staging both groups' routed tokens into one
                   ``moe_ffn`` launch; its greedy transcripts must equal
                   ``serve``'s.
     serve_overlap — ``serve_paged`` with overlapped admission: prompts
                   drain in chunks of 32 (one a tick, ahead of the decode
                   chunks), each landing in the paged pool at once; prints
                   the staged prefill seconds and the device ms of the
                   chunk attention (plain PyTorch, f32), counts how many
                   transcripts agree with ``serve_paged``'s, and holds the
                   logits at the end of chunked admissions against
                   monolithic prefill, both with a capacity no expert
                   bucket can overflow: in float32 within ``F32_TOL``, in
                   bf16 within ``LOGIT_TOL`` or, on a prompt whose top-2
                   routing a rounding flips, twice the distance between
                   the kernel and plain paths of its monolithic prefill.
                   Admission at one chunk a tick keeps
                   about two requests in the arena, so a second run (8
                   requests, 128 new tokens, the arena at its floor of one
                   slot) drives spills and fetches under staged admission.
     serve_budget — ``serve_paged``'s settings and prompts under EOS-aware
                   reservations (``reserve_mode="ewma"``) with a per-group
                   budget of 2048 tokens, quotas of 8 and 128 in turn:
                   ``enforce_budget`` must preempt, every request must
                   complete; prints the blocks swept back to the arena.
  5. trace       — one more serving window of each engine under
                   torch.profiler: device time by kernel family (copies
                   between the arena and the host tier included) and the
                   device's busy share.
  6. check       — prefill and decode logits through the kernels against
                   the plain versions (``ExecPolicy(impl="ref")``), on the
                   dense ring and on a paged arena with a scattered page
                   table; how far their greedy transcripts agree; and the
                   greedy transcripts of the paged engine against the dense
                   engine on the same prompts.  ``check_expert``: the same
                   weights packed into pinned host stores and served
                   expert-paged (a pool of r_w 0.25 of the spans); its
                   greedy transcripts must equal the dense engine's.
                   ``check_expert_kv``: those stores over ``serve_paged``'s
                   arena (r_c 0.4) in lockstep, on 16 prompts of 448..640
                   tokens that overflow it, against a fresh KV-paged
                   engine: transcripts and the whole ``kv_traffic()``
                   equal, spills and expert misses required.
  7. serve_expert — the mixtral engines are released; mixtral-8x7b at full
                   width and the deepest cut of its 32 layers that the
                   host holds (all 32 are ~93 GB of bf16 weights, more
                   than the card holds): MemAvailable must hold the stores
                   plus 20 % and 20 GiB (never below 8 layers; printed as
                   layers / of_layers), drawn on the card layer by layer
                   from a seed into pinned host stores, served
                   expert-paged with a device pool of r_w 0.5 of the
                   (layer, expert) spans: 8 requests of 32..256 prompt
                   tokens, 32 new tokens each.  Beside
                   the serve numbers: the bytes the gather moved over the
                   link, its seconds on the stream (CUDA events around
                   each call), their rate and the process's peak resident
                   host memory.  Then a trace window of it.
     serve_expert_module — that engine deleted, a module-batched one over
                   the same stores, depth and pool ratio serves the same 8
                   requests: its greedy transcripts must equal
                   ``serve_expert``'s, with fewer bytes read over the link
                   by the gather; then a trace window of it.
     serve_expert_kv — both offload ratios, the paper's setting: the same
                   stores and requests through windows at r_w 0.5 over a
                   block-paged KV arena of r_c 0.15 with its pinned host
                   tier (reckoned into the MemAvailable rule): the arena
                   must spill and fetch, every request complete; prints
                   how many transcripts equal ``serve_expert_module``'s.
                   Then the stores are released.
     policy      — HRM's policy search for mixtral-8x7b at full depth on
                   the ``h100`` preset, its link this run's ``h2d_copy``
                   and its CPU capacity MemAvailable, over
                   ``serve_expert``'s workload: the best policy, the best
                   with attention on the card (required feasible) beside
                   the hand-set r_w 0.5, HRM's modelled link bytes beside
                   ``serve_expert``'s measured and booked ones, and a timed
                   probe of the host's copy rate and f32 matmul rate.
     launch      — the port's ``launch/serve.py --smoke --hw h100`` on the
                   card: every request done.
  8. serve_mla   — deepseek-v3-671b at full width with the depth cut from
                   61 to 5 layers (its 3 dense-FFN prologue layers and 2
                   MoE layers, 53.2 GB of bf16 weights, every weight on the
                   card; all 61 are 1.3 TB), random weights from a seed,
                   over the block-paged latent arena at r_c 0.4 with
                   the same engine settings and traffic as serve_paged; the
                   prologue's latent rings stay dense.  Then a trace window
                   of it, and ``check_mla``: its logits through the kernels
                   against the plain path, on the dense cache and on a
                   paged latent arena with a scattered page table.

Then a ``{"kernels": [...]}`` line, the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; so does a machine without a CUDA device, and a copy of
this file outside the repository.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
LAYERS = 4                    # of mixtral-8x7b's 32
MLA_LAYERS = 5                # of deepseek-v3-671b's 61: 3 prologue + 2 MoE
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak, 700 W
CUDA_CORE_F32_OPS_PER_S = 67e12   # f32 outside the tensor cores, 700 W
SERVE = dict(ubatch=8, num_ubs=2, max_seq=512, decode_chunk=8)
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 24, (32, 384), 64
# The paged pool: 16 slots x 1024 positions = 1024 blocks of 16, of which
# 410 fit the arena.  One group's worst case (8 x (640 + 64) tokens, 352
# blocks) fits, so a chunk never preempts for lack of room, but the two
# groups together hold ~450 blocks on average: every tick spills the other
# group's cold blocks to the host tier and fetches its own back.
SERVE_PAGED = dict(ubatch=8, num_ubs=2, max_seq=1024, decode_chunk=8,
                   kv_paged=True, block_tokens=16, kv_gpu_ratio=0.4,
                   kv_prefetch=True)
PAGED_PROMPT_LENS = (128, 640)
# Overlapped admission over the paged pool at its floor: 8 of the paged
# requests, 128 new tokens each
OVERLAP_SPILL_REQUESTS, OVERLAP_SPILL_NEW_TOKENS = 8, 128
# Expert-granular paged weights: every layer's experts in pinned host
# stores, a device pool of half the (layer, expert) spans.
SERVE_EXPERT = dict(ubatch=8, num_ubs=2, max_seq=512, decode_chunk=8,
                    expert_paged=True, w_gpu_ratio=0.5)
EXPERT_REQUESTS, EXPERT_PROMPT_LENS, EXPERT_NEW_TOKENS = 8, (32, 256), 32
MIN_EXPERT_LAYERS = 8         # the deepest cut serve_expert accepts
# Both offload ratios at once (serve_expert_kv): windows, and an arena of
# 0.15 of the 512 blocks (77), below the ~90 the 8 requests' rows need
# together, so that it spills, fetches and preempts.
SERVE_EXPERT_KV = {**SERVE_EXPERT, "module_batch": True, "kv_paged": True,
                   "block_tokens": 16, "kv_gpu_ratio": 0.15}
# check_expert_kv: 16 prompts of 448..640 tokens overflow serve_paged's
# arena (at least 464 blocks of 410); the check phase's 8 prompts of
# 128..448 tokens hold ~150 and never spill
CHECK_KV_REQUESTS, CHECK_KV_PROMPT_LENS = 16, (448, 640)
# EOS-aware reservations (serve_budget): serve_paged's settings and prompts
# with a quarter of each group's 8192-token slice as its budget; quotas of
# 8 and 128 in turn stand in for requests that stop early, so the EWMA
# under-reserves the long ones and enforce_budget preempts them
SERVE_BUDGET = {**SERVE_PAGED, "reserve_mode": "ewma", "cache_tokens": 2048}
BUDGET_NEW_TOKENS = (NEW_TOKENS // 8, 2 * NEW_TOKENS)
HOST_MARGIN = 1.2             # MemAvailable must hold the stores + 20 %
HOST_RESERVE = 20 << 30       # ... and leave 20 GiB beside them
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
# A prompt whose routing a bf16 rounding flips: its chunked admission may
# move its logits this many times as far as the kernel and plain paths of
# its monolithic prefill move them.
FLIP_FACTOR = 2.0


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start
    (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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
    stream sleeps (so the host's enqueue cost is hidden) and, unless
    ``cold=False``, a 64 MB buffer is rewritten (so the 50 MB L2 is cold,
    as on the served path, where the expert weights stream through it
    between calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)

    def __call__(self, fn, iters: int = 10, warmup: int = 2,
                 cold: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(1_000_000)
            if cold:
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

    # moe_ffn at the decode bucket (the most launched shape) with every
    # bucket row full (the worst case), at the occupancy 8 routed rows give
    # it, and at the largest prefill bucket
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
               "library_ms": timer(library),
               "library_call": "torch.bmm chain (up, silu * up, down)"}
        emit({"phase": "kernel_bf16", **rec})
        if label == "decode":
            records.append(rec)
            rec["served_occupancy"] = moe_occupancy_case(
                torch, F, timer, rn, wi, wo, cfg_full, B, C)
    del wi, wo, x

    # gqa_decode over a half-filled 512-slot ring, as mid-serve, and over
    # the full ring (every slot valid)
    q, k, v = rn(B, H, Dh), rn(B, W, Hkv, Dh), rn(B, W, Hkv, Dh)
    lens = torch.randint(PROMPT_LENS[0], PROMPT_LENS[1] + NEW_TOKENS,
                         (B,), generator=g, device=DEVICE)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    kw = dict(scale=Dh ** -0.5)
    cases = []
    for valid in (torch.arange(W, device=DEVICE)[None, :] < lens[:, None],
                  torch.ones((B, W), dtype=torch.bool, device=DEVICE)):
        got, want = gqa_decode(q, k, v, valid, **kw), \
            ref.gqa_decode_ref(q, k, v, valid, **kw)
        err = max(max_err(a, b) for a, b in zip(got, want))
        nvalid = int(valid.sum())
        require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
                f"gqa_decode bf16 ({nvalid} valid): {err}")
        # q, the K and V rows of the valid slots only (the rest are never
        # needed), the mask, and the f32 (o_unnorm, m, l) outputs
        nbytes = 2 * B * H * Dh + 2 * nvalid * Hkv * 2 * Dh + B * W \
            + 4 * B * H * (Dh + 2)
        bms, by = bound(nbytes, 2 * nvalid * H * 2 * Dh)
        cases.append({
            "shape": {"B": B, "H": H, "Hkv": Hkv, "D": Dh, "W": W,
                      "valid": nvalid, "dtype": "bf16"},
            "max_abs_err": err,
            "ms": timer(lambda: gqa_decode(q, k, v, valid, **kw)),
            "plain_ms": timer(lambda: ref.gqa_decode_ref(q, k, v, valid,
                                                         **kw)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": timer(sdpa_gqa(
                F, q[:, :, None], kt, vt, H // Hkv,
                attn_mask=valid[:, None, None, :])),
            "library_call": "scaled_dot_product_attention, masked"})
    rec = {"name": "gqa_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/gqa_decode.cu",
           "replaces": "src/repro/kernels/gqa_decode.py:85", **cases[0],
           "full_ring": cases[1]}
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
                                        is_causal=True)),
           "library_call": "scaled_dot_product_attention, causal"}
    emit({"phase": "kernel_bf16", **rec})
    records.append(rec)
    records.append(kernel_paged(torch, F, timer, rn))
    kernel_deepseek(torch, F, timer, rn, records)
    records.append(kernel_mla(torch, timer, rn))
    records.append(kernel_expert_gather(torch, timer, rn))
    return records


def kernel_expert_gather(torch, timer, rn):
    """expert_gather at mixtral's span (2688 pages of 65536 bf16, 352 MB):
    one layer's 8 experts in a pinned host store, all of them also in a
    pool on the card, and three cases of 8 slots: no miss (8 activated,
    all resident), 4 misses (7 activated: 4 over the link, 3 from the
    pool, one pad slot; the shape of the first design's row) and 8 misses
    (8 activated, none resident).  Each is held against its plain version
    bit for bit (a copy) and timed beside the pinned host-to-device copy
    rate (``h2d_copy``), the least time the link and HBM allow, and the
    route through PyTorch calls (sel and the map read to the host, one
    ``index_select`` of the pool, one ``copy_`` per missing span).  The
    4-miss case is the kernels line's record."""
    from repro_torch.core import offload, paging
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gather import expert_gather
    from repro_torch.models.params import abstract_params, param_defs
    cfg = dataclasses.replace(_mixtral(), num_layers=1)
    page_elems = 1 << 16
    blocks = abstract_params(cfg, param_defs(cfg)["blocks"])
    pw = paging.PagedWeights.empty(blocks, page_elems, torch.device(DEVICE))
    try:
        key = "p0"
        em = pw.expert_manifests[key]
        store = pw.expert_pages[key]                  # (1, 8, 2688, 65536)
        E, ppe = em.num_experts, em.pages_per_expert
        for e in range(E):
            store[0, e].copy_(rn(ppe, page_elems))
        pool = torch.empty((E, ppe, page_elems), dtype=torch.bfloat16,
                           device=DEVICE)
        pool.copy_(store[0])
        span_bytes = em.span_bytes
        used = sum(math.prod(e.shape) for e in em.leaves) * 2
        dst = torch.empty((ppe, page_elems), dtype=torch.bfloat16,
                          device=DEVICE)
        h2d_ms = timer(lambda: dst.copy_(store[0, 0], non_blocking=True), 5,
                       1)
        h2d_rate = span_bytes / h2d_ms / 1e6                      # GB/s
        emit({"phase": "h2d_copy", "bytes": span_bytes, "ms": h2d_ms,
              "GBps": h2d_rate, "from": "pinned host (cudaHostRegister)",
              "store_bytes": store.nbytes,
              "pinned_bytes": offload.pinned_bytes()})
        del dst
        out_spans = torch.empty((E, ppe, page_elems), dtype=torch.bfloat16,
                                device=DEVICE)
        cases = []
        for misses, active, resident in (
                (0, list(range(E)), list(range(E))),
                (4, [0, 1, 2, 3, 5, 6, 7], [1, 3, 6]),
                (8, list(range(E)), [])):
            rmap = torch.full((1, E), -1, dtype=torch.int32, device=DEVICE)
            for e in resident:
                rmap[0, e] = e                       # pool slot e holds e
            sel = torch.tensor(active + [0] * (E - len(active)),
                               dtype=torch.int32, device=DEVICE)
            n_act = torch.tensor(len(active), dtype=torch.int32,
                                 device=DEVICE)
            args = (store, pool if resident else None, rmap, 0, sel, n_act,
                    em)
            got = expert_gather(*args)
            want = ref.expert_gather_ref(*args)
            torch.cuda.synchronize()
            exact = all(torch.equal(got[k], want[k]) for k in got)
            pads_zero = not any(bool(t[len(active):].any())
                                for t in got.values())
            require(exact and pads_zero,
                    f"expert_gather differs from its plain version at "
                    f"{misses} misses")
            err = max(max_err(got[k], want[k]) for k in got)
            del want
            n_host = sum(e not in resident for e in active)
            n_pool = len(active) - n_host
            host_bytes, dev_bytes = n_host * used, n_pool * used
            # the least time: the misses' bytes over the link at the
            # measured copy rate, or the pool's spans read plus every
            # output written at the data sheet's HBM rate, whichever is
            # longer (the two run side by side)
            link_ms = host_bytes / (h2d_rate * 1e9) * 1e3
            hbm_ms = (2 * dev_bytes + host_bytes) / HBM_BYTES_PER_S * 1e3
            bms = max(link_ms, hbm_ms)

            def library():
                """sel and the map to the host, then one index_select of
                the pool and one copy_ per missing span; pads zeroed."""
                s_h = sel.cpu().tolist()
                m_h = rmap.cpu()[0].tolist()
                n = int(n_act)
                res = [a for a in range(n) if m_h[s_h[a]] >= 0]
                if res:
                    idx = torch.tensor(res, device=DEVICE)
                    slots = torch.tensor([m_h[s_h[a]] for a in res],
                                         device=DEVICE)
                    out_spans.index_copy_(0, idx, pool.index_select(0, slots))
                for a in range(n):
                    if m_h[s_h[a]] < 0:
                        out_spans[a].copy_(store[0, s_h[a]],
                                           non_blocking=True)
                out_spans[n:].zero_()
                return out_spans
            lib = paging.unflatten_expert_span(library(), em)
            torch.cuda.synchronize()
            require(all(torch.equal(lib[k], got[k]) for k in got),
                    "the library route differs from expert_gather")
            ms = timer(lambda: expert_gather(*args), 5, 1)
            library_ms = timer(library, 5, 1)
            case = {"misses": misses, "active": len(active),
                    "from_host": n_host, "from_pool": n_pool,
                    "max_abs_err": err, "bit_exact": exact, "ms": ms,
                    "bound_ms": bms,
                    "bound_by": "bytes (link)" if link_ms >= hbm_ms
                    else "bytes (HBM)",
                    "bound_sum_ms": link_ms + 2 * dev_bytes
                    / HBM_BYTES_PER_S * 1e3,
                    "library_ms": library_ms,
                    "host_GBps": host_bytes / ms / 1e6,
                    "host_share_of_h2d": host_bytes / ms / 1e6 / h2d_rate,
                    "host_bytes": host_bytes, "pool_bytes": dev_bytes}
            emit({"phase": "expert_gather_case", **case})
            cases.append((case, args))
        case, args = cases[1]
        rec = {"name": "expert_gather", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/expert_gather.cu",
               "replaces": "src/repro/models/model.py:56",
               "replaces_note": "the port's own kernel, with no Pallas "
                                "counterpart: the XLA gather that "
                                "_ExpertCtx.make_fetch lowers to",
               "shape": {"A": E, "active": case["active"],
                         "from_host": case["from_host"],
                         "from_pool": case["from_pool"], "ppe": ppe,
                         "page_elems": page_elems, "span_bytes": span_bytes,
                         "dtype": "bf16"},
               "max_abs_err": case["max_abs_err"],
               "bit_exact": case["bit_exact"], "ms": case["ms"],
               "plain_ms": timer(lambda: ref.expert_gather_ref(*args), 3, 1),
               "bound_ms": case["bound_ms"], "bound_by": "bytes",
               "bound_rates": {"h2d_GBps_measured": h2d_rate,
                               "hbm_Bps": HBM_BYTES_PER_S},
               "library_ms": case["library_ms"],
               "library_call": "sel and map to the host, index_select of "
                               "the pool, copy_(non_blocking=True) per "
                               "missing span",
               "host_GBps": case["host_GBps"],
               "host_bytes": case["host_bytes"],
               "pool_bytes": case["pool_bytes"],
               "cases": [c for c, _ in cases]}
        emit({"phase": "kernel_bf16", **rec})
        return rec
    finally:
        pw.release()
        del pw
        torch.cuda.empty_cache()


def paged_inputs(torch, rng, lens, H, Hkv, D, bt, MB, NB, holes, dtype, rn):
    """A decode step over a head-major arena of NB blocks plus the trash
    block (NaN, so that a read of it shows): row b has written lens[b]
    positions and maps the blocks covering them and its next one (the
    fused token's) at physical blocks scattered over the arena; a block is
    left unmapped with probability `holes`, and a row of length 0 maps
    none.  Returns (q, cache, pos, new)."""
    import numpy as np
    B = len(lens)
    pt = np.full((B, MB), -1, np.int32)
    sp = np.full((NB + 1, bt), -1, np.int32)
    perm, used = rng.permutation(NB), 0
    for b, n in enumerate(lens):
        for lb in range(-(-(n + 1) // bt) if n else 0):
            if rng.random() < holes:
                continue
            pt[b, lb] = perm[used]
            used += 1
            p = lb * bt + np.arange(bt)
            sp[pt[b, lb]] = np.where(p < n, p, -1)
    k = rn(Hkv, NB + 1, bt, D, dtype=dtype)
    v = rn(Hkv, NB + 1, bt, D, dtype=dtype)
    k[:, NB] = float("nan")
    v[:, NB] = float("nan")
    cache = {"k": k, "v": v,
             "slot_pos": torch.as_tensor(sp, device=DEVICE),
             "page_table": torch.as_tensor(pt, device=DEVICE)}
    pos = torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE)
    new = {"k": rn(B, 1, Hkv, D, dtype=dtype),
           "v": rn(B, 1, Hkv, D, dtype=dtype)}
    return rn(B, H, D, dtype=dtype), cache, pos, new


def zero_trash(cache):
    """A copy of a paged layer cache with a zero trash block: the plain
    version gathers the trash for unmapped blocks (and masks it), so it is
    held against the kernel on finite values."""
    out = {n: a.clone() for n, a in cache.items()}
    for name in ("k", "v"):                  # head-major: block axis 1
        if name in out:
            out[name][:, -1] = 0
    for name in ("ckv", "kr"):               # latents: block axis 0
        if name in out:
            out[name][-1] = 0
    return out


def kernel_paged(torch, F, timer, rn):
    """paged_gqa_decode: f32 cases at small shapes (several block sizes,
    unmapped entries, a row with no block, window, softcap; unfused and
    fused), then bf16 at the served shapes with its timings."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gqa_decode import gqa_decode
    from repro_torch.kernels.paged_decode import paged_gqa_decode
    from repro_torch.models import kvcache
    from repro_torch.models.attention import decode_valid_mask
    rng = np.random.default_rng(SEED)
    f32 = torch.float32
    errs = []
    for B, H, Hkv, D, bt, MB, window, cap in (
            (3, 8, 2, 64, 16, 6, 0, 0.0), (2, 4, 1, 32, 4, 12, 10, 30.0),
            (2, 8, 8, 128, 32, 3, 0, 0.0), (2, 16, 2, 128, 8, 8, 0, 20.0)):
        lens = [int(n) for n in rng.integers(1, MB * bt - 1, B)]
        if B > 2:
            lens[0] = 0                          # maps no block at all
        q, cache, pos, new = paged_inputs(torch, rng, lens, H, Hkv, D, bt,
                                          MB, B * MB, 0.2, f32, rn)
        plain = zero_trash(cache)
        kw = dict(scale=D ** -0.5, window=window, attn_softcap=cap)
        got = ops.paged_gqa_decode(q, cache, pos, **kw)
        want = ops.paged_gqa_decode(q, plain, pos, impl="ref", **kw)
        fused = ops.paged_gqa_decode_fused(q, cache, new, pos, **kw)
        want_f = ops.paged_gqa_decode_fused(q, plain, new, pos, impl="ref",
                                            **kw)
        after = ops.paged_gqa_decode(q, cache, pos, **kw)
        torch.cuda.synchronize()
        for a, b in (*zip(got, want), *zip(fused, want_f)):
            errs.append(max_err(a, b))
            require(close(a, b, F32_TOL), f"paged f32 bt {bt}: {errs[-1]}")
        require(all(torch.equal(a, b) for a, b in zip(fused, after)),
                f"paged f32 bt {bt}: fused differs from write-then-attend")
        if lens[0] == 0:
            require(not any(bool(t[0].any()) for t in (*got, *fused)),
                    "paged f32: a row with no block gave nonzero partials")
    emit({"phase": "kernels_f32", "max_abs_err": {"paged_gqa_decode":
                                                  max(errs)},
          "tol": F32_TOL, "trash": "NaN, never read",
          "fused_equals_write_then_attend": "bit for bit"})

    # bf16 at the served shapes: 8 rows mid-serve, blocks of 16, the
    # paged engine's arena and page-table width
    cfg = _mixtral()
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bt = SERVE_PAGED["block_tokens"]
    MB = SERVE_PAGED["max_seq"] // bt
    slots = SERVE_PAGED["ubatch"] * SERVE_PAGED["num_ubs"]
    NB = round(SERVE_PAGED["kv_gpu_ratio"] * slots * MB)
    lens = [int(n) for n in rng.integers(
        PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + NEW_TOKENS,
        SERVE_PAGED["ubatch"])]
    q, cache, pos, new = paged_inputs(torch, rng, lens, H, Hkv, D, bt, MB,
                                      NB, 0.0, torch.bfloat16, rn)
    plain = zero_trash(cache)
    kn, vn = new["k"][:, 0], new["v"][:, 0]
    kw = dict(scale=D ** -0.5)
    args = (q, cache["k"], cache["v"], cache["slot_pos"],
            cache["page_table"], pos)
    got = paged_gqa_decode(*args, k_new=kn, v_new=vn, **kw)
    want = ref.paged_gqa_decode_ref(q, plain, pos, k_new=kn, v_new=vn, **kw)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"paged_gqa_decode bf16: {err}")
    mapped = int((cache["page_table"] >= 0).sum())
    valid = sum(lens) + len(lens)                # written + the fresh token
    B = len(lens)
    nbytes = (mapped * (Hkv * bt * 2 * D * 2 + bt * 4) + 2 * B * H * D
              + 2 * 2 * B * Hkv * D + 4 * B * (MB + 1)
              + 4 * B * H * (D + 2))
    bms, by = bound(nbytes, 2 * valid * H * 2 * D)
    view = kvcache.paged_view(plain)
    vk, vv = view["k"].contiguous(), view["v"].contiguous()
    vmask = decode_valid_mask(view["slot_pos"], pos, 0)
    kt, vt = vk.transpose(1, 2), vv.transpose(1, 2)
    rec = {"name": "paged_gqa_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
           "replaces": "src/repro/kernels/paged_decode.py:167",
           "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D, "bt": bt, "MB": MB,
                     "arena_blocks": NB, "mapped_blocks": mapped,
                     "valid": valid, "dtype": "bf16", "fused": True},
           "max_abs_err": err,
           "ms": timer(lambda: paged_gqa_decode(*args, k_new=kn, v_new=vn,
                                                **kw)),
           "plain_ms": timer(lambda: ref.paged_gqa_decode_ref(
               q, plain, pos, k_new=kn, v_new=vn, **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(
               F, q[:, :, None], kt, vt, H // Hkv,
               attn_mask=vmask[:, None, None, :])),
           "library_call": "scaled_dot_product_attention over the dense "
                           "view already gathered (gather not included)",
           "warm_ms": timer(lambda: paged_gqa_decode(
               *args, k_new=kn, v_new=vn, **kw), cold=False),
           "gather_ms": timer(lambda: kvcache.paged_view(plain)),
           "dense_gqa_decode_ms": timer(lambda: gqa_decode(
               q, vk, vv, vmask, **kw))}
    emit({"phase": "kernel_bf16", **rec})
    emit({"phase": "paged_sweep",
          **paged_sweep(torch, rng, timer, rn, q, Hkv, kw)})
    return rec


def paged_sweep(torch, rng, timer, rn, q, Hkv, kw):
    """Where the paged kernel's time goes, at the served shapes: its time
    against the number of mapped blocks per row (0 = launches only), beside
    the dense ring's ``gqa_decode`` over a max_seq-wide ring holding the
    same positions (the dense-vs-paged crossover behind ``auto`` taking the
    paged kernel for a paged cache)."""
    from repro_torch.kernels import paged_decode
    from repro_torch.kernels.gqa_decode import gqa_decode
    B, H, D = q.shape
    bt = SERVE_PAGED["block_tokens"]
    MB = SERVE_PAGED["max_seq"] // bt
    W = MB * bt
    k, v = rn(Hkv, B * MB + 1, bt, D), rn(Hkv, B * MB + 1, bt, D)
    kd, vd = rn(B, W, Hkv, D), rn(B, W, Hkv, D)
    perm = torch.as_tensor(rng.permutation(B * MB).astype("int32"),
                           device=DEVICE).view(B, MB)
    sp = torch.arange(W, dtype=torch.int32, device=DEVICE).view(MB, bt)
    slot_pos = torch.full((B * MB + 1, bt), -1, dtype=torch.int32,
                          device=DEVICE)
    slot_pos[perm.reshape(-1).long()] = sp.repeat(B, 1)
    rows = []
    for n in (0, 1, 8, 16, 32, 48, 64):
        pt = torch.where(torch.arange(MB, device=DEVICE) < n, perm, -1).int()
        pos = torch.full((B,), max(n * bt - 1, 0), dtype=torch.int32,
                         device=DEVICE)
        valid = (torch.arange(W, device=DEVICE) < n * bt)[None].repeat(B, 1)
        rows.append({"blocks_per_row": n, "paged_ms": timer(
            lambda: paged_decode.paged_gqa_decode(q, k, v, slot_pos, pt, pos,
                                                  **kw)),
            "dense_gqa_decode_ms": timer(
                lambda: gqa_decode(q, kd, vd, valid, **kw))})
    return {"occupancy": rows}


def routed_xbuf(torch, rn, E, C, D, top_k, rows):
    """The bucket buffer of one decode step: `rows` token rows, each routed
    to top_k of E experts drawn from a seeded generator, placed with
    first-come capacity C as moe_grouped places them
    (``moe.stage_bucket``); the slots no token reached stay zero.  Returns
    (xbuf, occupied experts)."""
    from repro_torch.models import moe
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    x = rn(rows, D)
    idx = torch.rand(rows, E, generator=g, device=DEVICE).topk(top_k, -1)[1]
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(rows, device=DEVICE).repeat_interleave(top_k)
    slot, keep = moe.stage_bucket(flat_e, E, C)
    xbuf = torch.zeros((E, C, D), dtype=x.dtype, device=DEVICE)
    xbuf[flat_e[keep], slot[keep]] = x[flat_t[keep]]
    return xbuf, int(xbuf.ne(0).any(-1).any(-1).sum())


def moe_occupancy_case(torch, F, timer, rn, wi, wo, cfg, rows, C):
    """moe_ffn at the decode bucket as `rows` routed rows fill it: held
    against its plain version, the empty rows exactly zero; the bound
    counts the weight bytes of the occupied experts only (the work this
    input needs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_ffn import moe_ffn
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    x, occ = routed_xbuf(torch, rn, E, C, D, cfg.top_k, rows)
    got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
    err = max_err(got, want)
    empty = ~x.ne(0).any(-1)
    require(close(got, want, BF16_OUT_TOL),
            f"moe_ffn bf16 {cfg.name} at served occupancy: {err}")
    require(bool((got[empty] == 0).all()),
            f"moe_ffn {cfg.name}: an empty bucket row gave a nonzero output")
    del got, want
    wi3 = wi.view(E, D, 2 * Fd)

    def library():
        h = torch.bmm(x, wi3)
        return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
    bms, by = bound(2 * (2 * E * C * D + 3 * occ * D * Fd),
                    6 * occ * C * D * Fd)
    rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                     "at": "decode", "routed_rows": rows,
                     "top_k": cfg.top_k, "occupied_experts": occ,
                     "occupied_rows": int((~empty).sum())},
           "max_abs_err": err, "empty_rows_exact_zero": True,
           "ms": timer(lambda: moe_ffn(x, wi, wo), 5, 1),
           "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library, 5, 1),
           "library_call": "torch.bmm chain (up, silu * up, down)"}
    emit({"phase": "kernel_bf16", "name": "moe_ffn", "model": cfg.name,
          "case": "served_occupancy", **rec})
    return rec


def _deepseek():
    from repro_torch.configs import get_config
    return get_config("deepseek-v3-671b")


def kernel_deepseek(torch, F, timer, rn, records):
    """moe_ffn at DeepSeek-V3's 256 experts (the decode bucket, C 1, and
    the largest prefill bucket) and flash_prefill at its MLA prefill shape
    (H = Hkv = 128, D 192, Dv 128), each against its plain version; the
    decode and prefill records join the mixtral ones as "deepseek"."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.moe_ffn import moe_ffn
    cfg = _deepseek()
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    by_name = {r["name"]: r for r in records}
    # 22.5 GB of bf16 expert weights: with every bucket full (the worst
    # case) the kernel streams them all; at the occupancy 8 routed rows
    # give, only the occupied experts'
    wi = rn(E, D, 2, Fd, std=D ** -0.5)
    wo = rn(E, Fd, D, std=Fd ** -0.5)
    wi3 = wi.view(E, D, 2 * Fd)
    for tokens, label in ((SERVE_PAGED["ubatch"], "decode"),
                          (PAGED_PROMPT_LENS[1], "prefill")):
        C = max(1, int(tokens * cfg.top_k * cfg.capacity_factor / E + 0.999))
        x = rn(E, C, D)
        got, want = moe_ffn(x, wi, wo), ref.moe_ffn_ref(x, wi, wo)
        err = max_err(got, want)
        require(close(got, want, BF16_OUT_TOL),
                f"moe_ffn bf16 deepseek {label}: {err}")
        del got, want

        def library():
            h = torch.bmm(x, wi3)
            return torch.bmm(F.silu(h[..., :Fd]) * h[..., Fd:], wo)
        bms, by = bound(2 * (2 * E * C * D + 3 * E * D * Fd),
                        6 * E * C * D * Fd)
        rec = {"shape": {"E": E, "C": C, "D": D, "F": Fd, "dtype": "bf16",
                         "at": label},
               "max_abs_err": err,
               "ms": timer(lambda: moe_ffn(x, wi, wo), 5, 1),
               "plain_ms": timer(lambda: ref.moe_ffn_ref(x, wi, wo), 3, 1),
               "bound_ms": bms, "bound_by": by,
               "library_ms": timer(library, 5, 1),
               "library_call": "torch.bmm chain (up, silu * up, down)"}
        emit({"phase": "kernel_bf16", "name": "moe_ffn",
              "model": "deepseek-v3-671b", **rec})
        by_name["moe_ffn"].setdefault("deepseek", {})[label] = rec
        if label == "decode":
            by_name["moe_ffn"]["deepseek"]["decode_served_occupancy"] = \
                moe_occupancy_case(torch, F, timer, rn, wi, wo, cfg, tokens,
                                   C)
    del wi, wo, wi3, x
    torch.cuda.empty_cache()

    H, dv = cfg.num_heads, cfg.v_head_dim
    dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    S = PROMPT_LENS[1]
    q, k, v = rn(1, S, H, dq), rn(1, S, H, dq), rn(1, S, H, dv)
    kw = dict(scale=dq ** -0.5)
    got, want = flash_prefill(q, k, v, **kw), ref.flash_prefill_ref(q, k, v,
                                                                    **kw)
    err = max_err(got, want)
    require(close(got, want, BF16_OUT_TOL), f"flash_prefill bf16 D 192: {err}")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    causal_pairs = S * (S + 1) // 2
    bms, by = bound(2 * (2 * S * H * dq + 2 * S * H * dv),
                    2 * causal_pairs * H * (dq + dv))
    rec = {"shape": {"B": 1, "S": S, "H": H, "Hkv": H, "D": dq, "Dv": dv,
                     "dtype": "bf16"},
           "max_abs_err": err,
           "ms": timer(lambda: flash_prefill(q, k, v, **kw)),
           "plain_ms": timer(lambda: ref.flash_prefill_ref(q, k, v, **kw)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(sdpa_gqa(F, qt, kt, vt, 1, is_causal=True,
                                        **kw)),
           "library_call": "scaled_dot_product_attention, causal"}
    emit({"phase": "kernel_bf16", "name": "flash_prefill",
          "model": "deepseek-v3-671b", **rec})
    by_name["flash_prefill"]["deepseek"] = {"prefill": rec}


def mla_inputs(torch, rng, lens, H, lat, dr, bt, MB, NB, holes, dtype, rn):
    """A decode step over a latent arena of NB blocks plus the trash block
    (NaN, so that a read of it shows), laid out as ``paged_inputs`` lays
    out the GQA arena.  Returns (qcat, cache, pos, new)."""
    import numpy as np
    B = len(lens)
    pt = np.full((B, MB), -1, np.int32)
    sp = np.full((NB + 1, bt), -1, np.int32)
    perm, used = rng.permutation(NB), 0
    for b, n in enumerate(lens):
        for lb in range(-(-(n + 1) // bt) if n else 0):
            if rng.random() < holes:
                continue
            pt[b, lb] = perm[used]
            used += 1
            p = lb * bt + np.arange(bt)
            sp[pt[b, lb]] = np.where(p < n, p, -1)
    ckv = rn(NB + 1, bt, lat, dtype=dtype)
    kr = rn(NB + 1, bt, dr, dtype=dtype)
    ckv[NB] = float("nan")
    kr[NB] = float("nan")
    cache = {"ckv": ckv, "kr": kr,
             "slot_pos": torch.as_tensor(sp, device=DEVICE),
             "page_table": torch.as_tensor(pt, device=DEVICE)}
    pos = torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE)
    new = {"ckv": rn(B, 1, lat, dtype=dtype), "kr": rn(B, 1, dr, dtype=dtype)}
    return rn(B, H, lat + dr, dtype=dtype), cache, pos, new


def kernel_mla(torch, timer, rn):
    """paged_mla_decode: f32 cases (blocks of 4, 8 and 16, unmapped
    entries, a row that maps nothing, a NaN trash block; unfused and
    fused, and fused against write-then-attend bit for bit), then bf16 at
    DeepSeek-V3's served shape with its timings."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_mla_decode import paged_mla_decode
    from repro_torch.models import kvcache
    from repro_torch.models.attention import decode_valid_mask
    rng = np.random.default_rng(SEED + 5)
    f32 = torch.float32
    errs = []
    for B, H, lat, dr, bt, MB in ((3, 16, 512, 64, 16, 6),
                                  (2, 4, 32, 8, 4, 12),
                                  (2, 32, 128, 32, 8, 9),
                                  (2, 128, 512, 64, 16, 5)):
        lens = [int(n) for n in rng.integers(1, MB * bt - 1, B)]
        if B > 2:
            lens[0] = 0                          # maps no block at all
        q, cache, pos, new = mla_inputs(torch, rng, lens, H, lat, dr, bt,
                                        MB, B * MB, 0.2, f32, rn)
        plain = zero_trash(cache)
        kw = dict(scale=(lat // 4 + dr) ** -0.5)
        got = ops.paged_mla_decode(q, cache, pos, **kw)
        want = ops.paged_mla_decode(q, plain, pos, impl="ref", **kw)
        fused = ops.paged_mla_decode_fused(q, cache, new, pos, **kw)
        want_f = ops.paged_mla_decode_fused(q, plain, new, pos, impl="ref",
                                            **kw)
        after = ops.paged_mla_decode(q, cache, pos, **kw)
        torch.cuda.synchronize()
        for a, b in (*zip(got, want), *zip(fused, want_f)):
            errs.append(max_err(a, b))
            require(close(a, b, F32_TOL), f"mla f32 bt {bt}: {errs[-1]}")
        require(all(torch.equal(a, b) for a, b in zip(fused, after)),
                f"mla f32 bt {bt}: fused differs from write-then-attend")
        if lens[0] == 0:
            require(not any(bool(t[0].any()) for t in (*got, *fused)),
                    "mla f32: a row with no block gave nonzero partials")
    emit({"phase": "kernels_f32", "max_abs_err": {"paged_mla_decode":
                                                  max(errs)},
          "tol": F32_TOL, "trash": "NaN, never read",
          "fused_equals_write_then_attend": "bit for bit"})

    # bf16 at the served shape: 8 rows mid-serve over the paged engine's
    # arena (r_c 0.4 of 16 slots x 64 blocks of 16)
    cfg = _deepseek()
    H, lat, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    bt = SERVE_PAGED["block_tokens"]
    MB = SERVE_PAGED["max_seq"] // bt
    slots = SERVE_PAGED["ubatch"] * SERVE_PAGED["num_ubs"]
    NB = round(SERVE_PAGED["kv_gpu_ratio"] * slots * MB)
    lens = [int(n) for n in rng.integers(
        PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + NEW_TOKENS,
        SERVE_PAGED["ubatch"])]
    q, cache, pos, new = mla_inputs(torch, rng, lens, H, lat, dr, bt, MB, NB,
                                    0.0, torch.bfloat16, rn)
    plain = zero_trash(cache)
    cn, rn_ = new["ckv"][:, 0], new["kr"][:, 0]
    scale = (cfg.qk_nope_head_dim + dr) ** -0.5
    args = (q, cache["ckv"], cache["kr"], cache["slot_pos"],
            cache["page_table"], pos)
    got = paged_mla_decode(*args, scale=scale, ckv_new=cn, kr_new=rn_)
    want = ref.paged_mla_decode_ref(q, plain, pos, scale=scale, ckv_new=cn,
                                    kr_new=rn_)
    err = max(max_err(a, b) for a, b in zip(got, want))
    require(all(close(a, b, F32_TOL) for a, b in zip(got, want)),
            f"paged_mla_decode bf16: {err}")
    mapped = int((cache["page_table"] >= 0).sum())
    valid = sum(lens) + len(lens)                # written + the fresh token
    B = len(lens)
    # the mapped blocks' latents and slot_pos, qcat, the fresh latents, the
    # page table and positions read once; the f32 partials written once
    nbytes = (mapped * bt * ((lat + dr) * 2 + 4) + 2 * B * H * (lat + dr)
              + 2 * B * (lat + dr) + 4 * B * (MB + 1) + 4 * B * H * (lat + 2))
    ops_ = 2 * valid * H * (lat + dr) + 2 * valid * H * lat
    bms, by = bound(nbytes, ops_)

    def library():
        """The gather, then one matmul / masked softmax / matmul chain over
        the gathered dense view (normalized output)."""
        view = kvcache.paged_view(plain)
        keys = torch.cat([view["ckv"], view["kr"]], -1)        # (B, W, 576)
        s = torch.matmul(q, keys.transpose(1, 2)) * scale      # (B, H, W)
        vm = decode_valid_mask(view["slot_pos"], pos, 0)
        s = s.masked_fill(~vm[:, None, :], float("-inf"))
        return torch.matmul(torch.softmax(s.float(), -1).to(q.dtype),
                            view["ckv"])
    rec = {"name": "paged_mla_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_mla_decode.cu",
           "replaces": "src/repro/kernels/paged_decode.py:322",
           "shape": {"B": B, "H": H, "lat": lat, "dr": dr, "bt": bt,
                     "MB": MB, "arena_blocks": NB, "mapped_blocks": mapped,
                     "valid": valid, "dtype": "bf16", "fused": True},
           "max_abs_err": err,
           "ms": timer(lambda: paged_mla_decode(*args, scale=scale,
                                                ckv_new=cn, kr_new=rn_)),
           "plain_ms": timer(lambda: ref.paged_mla_decode_ref(
               q, plain, pos, scale=scale, ckv_new=cn, kr_new=rn_)),
           "bound_ms": bms, "bound_by": by,
           "library_ms": timer(library),
           "library_call": "kvcache.paged_view gather + torch.matmul, "
                           "masked softmax, torch.matmul over the dense view "
                           "(normalized output)",
           "warm_ms": timer(lambda: paged_mla_decode(
               *args, scale=scale, ckv_new=cn, kr_new=rn_), cold=False),
           "cuda_core_f32_bound_ms": ops_ / CUDA_CORE_F32_OPS_PER_S * 1e3}
    emit({"phase": "kernel_bf16", **rec})
    return rec


def _mixtral():
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b")


def serve_run(torch, np, eng, ops, prompt_lens, n_requests, seed,
              new_tokens=NEW_TOKENS):
    """Submit `n_requests` seeded prompts and run the engine until idle,
    with every kernel's launch count set to 0 just before and read just
    after, and admission prefill (monolithic, or the staged chunks of
    overlapped admission) timed apart (synchronized).  `new_tokens` is
    every request's quota, or a tuple of quotas the requests take in
    turn.  Checks that every request finished with in-range tokens.
    Returns the prompts, the numbers and the transcripts in submission
    order."""
    prefill_s = [0.0]
    step_name = "_prefill_chunk" if eng.ecfg.overlap else "_prefill"
    inner = getattr(eng, step_name)

    def timed_prefill(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t
        return out
    setattr(eng, step_name, timed_prefill)

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    prompts = [rng.integers(2, eng.cfg.vocab_size, n) for n in lens]
    quotas = (new_tokens if isinstance(new_tokens, tuple)
              else (new_tokens,))
    quota = [quotas[i % len(quotas)] for i in range(n_requests)]
    rids = [eng.submit(p, q) for p, q in zip(prompts, quota)]
    torch.cuda.synchronize()
    tokens0, steps0 = eng.tokens_out, eng.steps
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    setattr(eng, step_name, inner)
    reqs = [eng.scheduler.requests[r] for r in rids]
    require(all(r.done and not r.aborted for r in reqs),
            "not every request finished")
    for r, q in zip(reqs, quota):
        toks = out[r.rid]
        require(len(toks) == q or (toks and toks[-1] == 1),
                f"request {r.rid}: {len(toks)} tokens")
        require(all(0 <= t < eng.cfg.vocab_size for t in toks),
                f"request {r.rid}: token out of range")
    decode_s = wall - prefill_s[0]
    tokens = eng.tokens_out - tokens0
    return prompts, {
        "requests": n_requests, "prompt_tokens": int(lens.sum()),
        "new_tokens_each": new_tokens, "decode_tokens": tokens,
        "engine_steps": eng.steps - steps0, "wall_s": wall,
        "prefill_s": prefill_s[0], "decode_s": decode_s,
        "decode_tok_per_s": tokens / decode_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches}, [out[r] for r in rids]


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
    prompts, res, outs = serve_run(torch, np, eng, ops, PROMPT_LENS,
                                   N_REQUESTS, SEED)
    emit({"phase": "serve", "model": "mixtral-8x7b", "layers": LAYERS,
          "of_layers": _mixtral().num_layers, "params": count_params(cfg),
          "engine": SERVE, **res})
    launches = res["launches"]
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"a kernel of the dense path never launched: {launches}")
    return eng, prompts[:2], launches, outs


def phase_serve_module(torch, np, ops, params, want, launches_serve):
    """``serve``'s weights, settings and requests with module-based
    batching (G = num_ubs = 2): one decode dispatch a window of both
    groups.  Its greedy transcripts must equal ``serve``'s token for token
    (every row computes as in its lockstep dispatch), with fewer
    ``moe_ffn`` launches (one a layer a window, not one a group)."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    settings = {**SERVE, "module_batch": True}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**settings),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, outs = serve_run(torch, np, eng, ops, PROMPT_LENS, N_REQUESTS,
                             SEED)
    launches = res["launches"]
    emit({"phase": "serve_module", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": settings, **res,
          "module_groups": eng.weight_traffic()["module_groups"],
          "moe_ffn_launches_serve": launches_serve["moe_ffn"],
          "identical_requests": sum(a == b for a, b in zip(outs, want)),
          "requests_total": len(want)})
    require(outs == want, "module-batched greedy transcripts differ from "
                          "serve's")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "gqa_decode", "flash_prefill")),
            f"a kernel of the module-batched path never launched: "
            f"{launches}")
    require(launches["moe_ffn"] < launches_serve["moe_ffn"],
            f"windows launched moe_ffn no fewer times: {launches}")
    return launches


def phase_serve_paged(torch, np, ops, params):
    """The block-paged KV path at full width: spills, on-demand fetches and
    prefetches through the pinned host tier."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**SERVE_PAGED),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    # host-side cost of the paged control plane: executing the plans
    # (enqueueing the copies) and building + uploading the page tables
    host = {"kv_exec_s": 0.0, "kv_exec_calls": 0, "page_table_uploads": 0,
            "compose_s": 0.0}
    exec_, compose = eng._kv_exec, eng._compose_kv

    def timed_exec(ops_):
        t = time.perf_counter()
        exec_(ops_)
        host["kv_exec_s"] += time.perf_counter() - t
        host["kv_exec_calls"] += 1

    def timed_compose(*args):
        t = time.perf_counter()
        out = compose(*args)
        host["compose_s"] += time.perf_counter() - t
        host["page_table_uploads"] += 1
        return out
    eng._kv_exec, eng._compose_kv = timed_exec, timed_compose
    prompts, res, outs = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                                   N_REQUESTS, SEED + 2)
    eng._kv_exec, eng._compose_kv = exec_, compose
    traffic = eng.kv_traffic()
    preempted = sum(r.preemptions for r in eng.scheduler.requests.values())
    emit({"phase": "serve_paged", "model": "mixtral-8x7b", "layers": LAYERS,
          "engine": SERVE_PAGED, **res, "preemptions": preempted,
          "arena_bytes": traffic["arena_bytes"],
          "dense_equiv_bytes": traffic["dense_equiv_bytes"],
          "h2d_bytes": traffic["h2d_bytes"], "d2h_bytes": traffic["d2h_bytes"],
          "host": host, "kv_traffic": traffic})
    launches = res["launches"]
    require(traffic["spills"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the host tier was not exercised: {traffic}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_gqa_decode", "flash_prefill")),
            f"a kernel of the paged path never launched: {launches}")
    require(launches["gqa_decode"] == 0,
            f"the paged path ran the dense decode kernel: {launches}")
    return eng, launches, outs, res


def phase_serve_overlap(torch, np, ops, params, want):
    """``serve_paged``'s weights, settings and requests with overlapped
    chunked-prefill admission (chunks of 32 tokens, one a tick ahead of
    the decode chunks, each landing in the paged pool at once): the staged
    prefill seconds, the device time of the chunk attention (plain
    PyTorch in f32 over the whole 1024-slot ring, CUDA events around each
    call), and how many transcripts agree with ``serve_paged``'s (not
    required: the capacity-bucketed MoE drops other tokens in a 32-token
    chunk than in a whole prompt, and ``flash_prefill`` rounds P to bf16
    where the chunk attention does not).  Then the logits check below."""
    from repro_torch.models import attention
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    settings = {**SERVE_PAGED, "overlap": True, "prefill_chunk": 32}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**settings),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    timed = []
    inner = attention.chunk_attention_ring

    def timed_attention(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(*args, **kw)
        ev[1].record()
        timed.append(ev)
        return out
    attention.chunk_attention_ring = timed_attention
    try:
        prompts, res, outs = serve_run(torch, np, eng, ops,
                                       PAGED_PROMPT_LENS, N_REQUESTS,
                                       SEED + 2)
    finally:
        attention.chunk_attention_ring = inner
    chunk_ms = sum(a.elapsed_time(b) for a, b in timed)
    traffic = eng.kv_traffic()
    emit({"phase": "serve_overlap", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": settings, **res,
          "staged_prefill_s": res["prefill_s"],
          "chunk_attention_calls": len(timed),
          "chunk_attention_device_ms": chunk_ms,
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values()),
          "identical_requests_vs_serve_paged": sum(
              a == b for a, b in zip(outs, want)),
          "agree_tokens_vs_serve_paged": sum(
              x == y for a, b in zip(outs, want) for x, y in zip(a, b)),
          "requests_total": len(want), "kv_traffic": traffic})
    launches = res["launches"]
    require(all(launches[k] > 0 for k in ("moe_ffn", "paged_gqa_decode")),
            f"a kernel of the overlap path never launched: {launches}")
    phase_check_overlap(torch, cfg, params, prompts[:8], eng)
    # one chunk a tick admits a request of ~384 prompt tokens in ~12
    # ticks, while one decodes its 64 tokens in 8: about two requests hold
    # blocks at a time, under 60 of the 410, so the run above never
    # spills.  The host tier under staged admission is driven here: the
    # arena at its floor (one slot's 64 blocks) and 128 new tokens, so
    # that a decoding request and the staged one overflow it
    spill = {**settings, "kv_gpu_ratio": 0.0}
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**spill),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    _, res, _ = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                          OVERLAP_SPILL_REQUESTS, SEED + 2,
                          OVERLAP_SPILL_NEW_TOKENS)
    traffic = eng.kv_traffic()
    emit({"phase": "serve_overlap_spill", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": spill, **res, "kv_traffic": traffic})
    require(traffic["spills"] > 0 and traffic["misses"] > 0,
            f"the host tier was not exercised under overlap: {traffic}")
    return launches


def phase_serve_budget(torch, np, ops, params, paged_res):
    """``serve_paged``'s weights, settings and prompts under EOS-aware
    reservations (``reserve_mode="ewma"``) with a tight per-group budget
    (``SERVE_BUDGET``): the EWMA of finished lengths under-reserves the
    long requests, so ``enforce_budget`` must preempt (recompute
    preemption) and the engine sweeps the preempted slots' blocks back to
    the arena; every request must still complete its quota."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import SlotState

    cfg = dataclasses.replace(_mixtral(), num_layers=LAYERS)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, EngineConfig(**SERVE_BUDGET),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    swept = {"blocks": 0, "slots": 0}
    sweep = eng._kv_sweep

    def counted_sweep():
        for grp in eng.scheduler.slots:
            for s in grp:
                n = eng._kv.n_mapped(eng._slot_of(s))
                if s.state is SlotState.FREE and n:
                    swept["blocks"] += n
                    swept["slots"] += 1
        sweep()
    eng._kv_sweep = counted_sweep
    try:
        _, res, _ = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                              N_REQUESTS, SEED + 2, BUDGET_NEW_TOKENS)
    finally:
        eng._kv_sweep = sweep
    preempted = sum(r.preemptions for r in eng.scheduler.requests.values())
    emit({"phase": "serve_budget", "model": "mixtral-8x7b",
          "layers": LAYERS, "engine": SERVE_BUDGET, **res,
          "decode_tok_per_s_serve_paged": paged_res["decode_tok_per_s"],
          "preemptions": preempted, "swept": swept,
          "gen_len_ewma": eng.scheduler.gen_ewma.value,
          "kv_traffic": eng.kv_traffic()})
    launches = res["launches"]
    require(preempted > 0, "the tight budget never preempted")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_gqa_decode", "flash_prefill")),
            f"a kernel of the budget path never launched: {launches}")
    return launches


def phase_check_overlap(torch, cfg, params, prompts, eng):
    """The logits at the end of chunked admissions (the engine's chunk
    widths, on a batch-1 scratch) against monolithic prefill of the same
    prompts.  Capacity-bucketed MoE drops tokens by how many share a
    call, so both sides run with a capacity factor of E / top_k, at which
    no expert bucket can overflow.  Held in float32 (the kernels' f32
    bodies), where the two differ only in summation order, within
    ``F32_TOL``.  In bf16, as served, the two round at other points
    (``flash_prefill`` rounds P, chunk attention does not; a product's
    bits change with its row count), and where a rounding flips a token's
    top-2 experts the logits move by more than ``LOGIT_TOL``.  How far one
    prompt's logits move under such a flip is measured by the kernel and
    plain paths of its monolithic prefill (two other roundings of the same
    prompt), so each prompt is held within ``max(LOGIT_TOL,
    FLIP_FACTOR x`` that distance``)``: a prompt that no flip moves, at
    ``LOGIT_TOL``."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving import steps

    nd = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                             / cfg.top_k)
    max_seq = SERVE_PAGED["max_seq"]

    def prefill(c, p, pol, prompt, chunked):
        cache = kvcache.init_cache(c, 1, max_seq, device=DEVICE)
        if not chunked:
            return steps.make_prefill_fill_step(c, pol)(
                p, torch.as_tensor(prompt[None].astype("int32"),
                                   device=DEVICE), cache,
                torch.tensor([len(prompt)], dtype=torch.int32,
                             device=DEVICE))[0]
        step, t = steps.make_prefill_chunk(c, pol), 0
        while t < len(prompt):
            width = eng._chunk_bucket(len(prompt) - t)
            n = min(width, len(prompt) - t)
            toks = torch.zeros((1, width), dtype=torch.int32, device=DEVICE)
            toks[0, :n] = torch.as_tensor(prompt[t:t + n].astype("int32"))
            logits, cache = step(
                p, toks, cache,
                torch.tensor([n], dtype=torch.int32, device=DEVICE))
            t += n
        return logits

    def to_f32(tree):
        return {k: to_f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}

    kern = ExecPolicy(moe_impl="grouped", use_kernels=True)
    plain = ExecPolicy(moe_impl="grouped", use_kernels=False, impl="ref")
    worst = {"float32": 0.0, "bfloat16": 0.0,
             "bfloat16_kernel_vs_plain": 0.0}
    per_prompt = []
    nd32, p32 = dataclasses.replace(nd, dtype="float32"), to_f32(params)
    for prompt in prompts:
        row = {"prompt_tokens": len(prompt)}
        for key, c, p in (("float32", nd32, p32), ("bfloat16", nd, params)):
            got = prefill(c, p, kern, prompt, True)
            want = prefill(c, p, kern, prompt, False)
            require(bool(torch.isfinite(got).all())
                    and got.shape == want.shape == (1, nd.vocab_size),
                    f"bad chunked-admission logits ({key})")
            row[key] = max_err(got, want)
        row["bfloat16_kernel_vs_plain"] = max_err(
            want, prefill(nd, params, plain, prompt, False))
        row["bfloat16_tol"] = max(LOGIT_TOL, FLIP_FACTOR
                                  * row["bfloat16_kernel_vs_plain"])
        for key in worst:
            worst[key] = max(worst[key], row[key])
        per_prompt.append(row)
    del p32
    torch.cuda.empty_cache()
    emit({"phase": "check_overlap", "prompts": len(prompts),
          "max_abs_logit_diff": worst, "f32_tol": F32_TOL,
          "logit_tol": LOGIT_TOL, "flip_factor": FLIP_FACTOR,
          "per_prompt": per_prompt})
    require(worst["float32"] <= F32_TOL,
            f"chunked admission logits differ from monolithic prefill in "
            f"float32: {worst}")
    require(all(r["bfloat16"] <= r["bfloat16_tol"] for r in per_prompt),
            f"chunked admission logits differ from monolithic prefill in "
            f"bf16: {per_prompt}")


def phase_trace(torch, np, eng, label, prompt_lens, n_requests,
                new_tokens=NEW_TOKENS // 4):
    """A separate, profiled serving window on an engine: device time by
    kernel family (copies between the arena and the host tier included)
    and the device's busy share of the window's wall time, profiler on.
    The serve phases' numbers are taken with the profiler off.  The
    windows are short (two decode chunks a group; one on the expert-paged
    paths): the profiler's processing takes several times the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for n in rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests):
        eng.submit(rng.integers(2, eng.cfg.vocab_size, n), new_tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    families = {"moe_ffn": ("moe_flags", "moe_up", "moe_down", "moe_reduce"),
                "paged_mla_decode": ("mla_chunk", "mla_tc", "mla_combine"),
                "paged_gqa_decode": ("paged_chunk", "paged_tc",
                                     "paged_combine"),
                "gqa_decode": ("gqa_chunk", "gqa_tc", "gqa_combine"),
                "flash_prefill": ("flash_prefill",),
                "expert_gather": ("expert_gather_kernel",
                                  "expert_plan_kernel"),
                "matmul": ("gemm", "nvjet", "xmma", "cutlass", "splitk"),
                "memcpy_htod": ("Memcpy HtoD",),
                "memcpy_dtoh": ("Memcpy DtoH",)}
    ms = {k: 0.0 for k in (*families, "other")}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        fam = next((f for f, keys in families.items()
                    if any(k in ev.key for k in keys)), "other")
        ms[fam] += ev.self_device_time_total / 1e3
    device_ms = sum(ms.values())
    # device time sums over streams: where copies on a side stream overlap
    # kernels (the expert-paged path), it can exceed the wall time, so the
    # kernels' share is given apart
    kernel_ms = device_ms - ms["memcpy_htod"] - ms["memcpy_dtoh"]
    emit({"phase": "trace", "engine": label, "requests": n_requests,
          "new_tokens_each": new_tokens,
          "wall_ms": wall * 1e3, "device_ms": device_ms,
          "device_busy_share": device_ms / (wall * 1e3),
          "kernel_busy_share": kernel_ms / (wall * 1e3),
          "device_ms_by_family": ms, "host_peak_rss": host_peak_rss()})


def paged_copy(torch, cfg, dense, rng):
    """A batch-1 paged layout of a dense prefilled cache: a fresh arena
    whose blocks for the row (those covering its prompt and its next
    token) sit at physical blocks scattered over the arena; the rings that
    stay dense (the prologue's) are copied."""
    from repro_torch.models import kvcache
    bt = SERVE_PAGED["block_tokens"]
    keys = kvcache.paged_period_keys(cfg)
    MB = dense[keys[0]]["slot_pos"].shape[-1] // bt
    nb = 4 * MB
    arena = kvcache.init_paged_arena(cfg, nb, bt, device=DEVICE)
    n = int(dense["pos"][0]) + 1
    pt = torch.full((1, MB), -1, dtype=torch.int32)
    pt[0, :-(-n // bt)] = torch.as_tensor(
        rng.permutation(nb)[:-(-n // bt)].astype("int32"))
    ptl = pt.to(DEVICE).expand((cfg.num_periods, 1, MB))
    cache = {k: (clone_cache(v) if isinstance(v, dict) else v.clone())
             for k, v in dense.items() if k not in arena}
    for key, g in arena.items():
        cache[key] = {**g, "page_table": ptl}
    return kvcache.insert_slot(cache, dense, 0)


def clone_cache(cache):
    return {k: (clone_cache(v) if isinstance(v, dict)
                else v if k == "page_table" else v.clone())
            for k, v in cache.items()}


def phase_check(torch, np, cfg, params, prompts, eng, eng_paged):
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.serving import steps

    worst = {"prefill": 0.0, "decode": 0.0, "decode_paged": 0.0}
    agree, total = 0, 0
    rng = np.random.default_rng(SEED)
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
        # one decode step, both paths fed the kernel path's greedy token;
        # on the paged layout both read the same arena and page table
        first = torch.argmax(outs["auto"]["prefill"], -1).to(
            torch.int32)[:, None]
        paged = paged_copy(torch, cfg, outs["auto"]["cache"], rng)
        for impl, o in outs.items():
            fwd = forward(cfg, params, first, cache=clone_cache(paged),
                          mode="decode", policy=o["pol"])
            o["decode_paged"] = unembed(cfg, params, fwd["hidden"][:, -1])
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
    # the paged engine against the dense engine, same prompts and weights
    prng = np.random.default_rng(SEED + 3)
    engine_prompts = [prng.integers(2, cfg.vocab_size, n) for n in
                      prng.integers(PAGED_PROMPT_LENS[0],
                                    SERVE["max_seq"] - NEW_TOKENS, 8)]
    runs = []
    for e in (eng, eng_paged):
        rids = [e.submit(p, NEW_TOKENS // 4) for p in engine_prompts]
        out = e.run_until_idle()
        runs.append([out[r] for r in rids])
    eng_agree = sum(a == b for x, y in zip(*runs) for a, b in zip(x, y))
    eng_total = sum(len(x) for x in runs[0])
    emit({"phase": "check", "prompts": len(prompts),
          "engine_prompts": len(engine_prompts),
          "max_abs_logit_diff": worst, "tol": LOGIT_TOL,
          "greedy_agree": agree, "greedy_total": total,
          "paged_vs_dense_engine_agree": eng_agree,
          "paged_vs_dense_engine_total": eng_total,
          "paged_vs_dense_engine_identical_requests": sum(
              x == y for x, y in zip(*runs))})
    require(all(v <= LOGIT_TOL for v in worst.values()),
            f"kernel path logits differ from the plain path: {worst}")
    return engine_prompts, runs[0]


def phase_check_expert(torch, np, eng, engine_prompts, want):
    """The expert-paged engine on the dense engine's weights (4 layers,
    packed into pinned host stores; a pool of r_w 0.25 of the 32 spans),
    grouped moe_ffn: its greedy transcripts on the check phase's prompts
    must equal the dense engine's token for token."""
    from repro_torch.core import offload
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    settings = {**SERVE, "expert_paged": True, "w_gpu_ratio": 0.25}
    ecfg = EngineConfig(**settings)
    t0 = time.perf_counter()
    e = Engine(eng.cfg, eng.params, ecfg,
               ExecPolicy(moe_impl="grouped", use_kernels=True),
               device=DEVICE)
    pack_s = time.perf_counter() - t0
    try:
        rids = [e.submit(p, NEW_TOKENS // 4) for p in engine_prompts]
        out = e.run_until_idle()
        got = [out[r] for r in rids]
        agree = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
        traffic = e.weight_traffic()
        emit({"phase": "check_expert", "layers": eng.cfg.num_layers,
              "engine": settings,
              "pool_spans": sum(r.capacity for r in e.residency.values()),
              "pinned_bytes": offload.pinned_bytes(), "pack_s": pack_s,
              "requests": len(rids),
              "expert_vs_dense_engine_agree": agree,
              "expert_vs_dense_engine_total": sum(len(x) for x in want),
              "identical_requests": sum(x == y for x, y in zip(got, want)),
              "weight_traffic": {k: traffic[k] for k in (
                  "hits", "misses", "prefetches", "predicted_prefetches",
                  "evictions", "h2d_bytes")}})
        require(got == want, "expert-paged greedy transcripts differ from "
                             "the dense engine's")
    finally:
        e.paged_blocks.release()


def phase_check_expert_kv(torch, np, ops, eng):
    """Both offload paths at once on the 4-layer ``serve`` weights: packed
    into pinned host stores and served expert-paged (a pool of r_w 0.25)
    over ``serve_paged``'s block-paged arena (r_c 0.4), in lockstep, on
    ``CHECK_KV_REQUESTS`` prompts that overflow the arena.  A fresh engine
    with ``serve_paged``'s settings serves the same prompts first.  The
    greedy transcripts must be equal token for token, and so must the
    whole ``kv_traffic()`` (expert paging does not touch the KV plan);
    the arena must spill, the pool must miss, and the run must launch
    ``moe_ffn``, ``paged_gqa_decode``, ``expert_gather`` and
    ``flash_prefill``."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    rng = np.random.default_rng(SEED + 9)
    lens = rng.integers(CHECK_KV_PROMPT_LENS[0], CHECK_KV_PROMPT_LENS[1] + 1,
                        CHECK_KV_REQUESTS)
    prompts = [rng.integers(2, eng.cfg.vocab_size, n) for n in lens]
    settings = {**SERVE_PAGED, "expert_paged": True, "w_gpu_ratio": 0.25}
    runs = {}
    for name, st in (("kv", SERVE_PAGED), ("expert_kv", settings)):
        e = Engine(eng.cfg, eng.params, EngineConfig(**st),
                   ExecPolicy(moe_impl="grouped", use_kernels=True),
                   device=DEVICE)
        try:
            rids = [e.submit(p, NEW_TOKENS // 4) for p in prompts]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = e.run_until_idle()
            torch.cuda.synchronize()
            runs[name] = {
                "out": [out[r] for r in rids],
                "wall_s": time.perf_counter() - t0,
                "launches": ops.launch_counts(),
                "done": all(e.scheduler.requests[r].done for r in rids),
                "preemptions": sum(e.scheduler.requests[r].preemptions
                                   for r in rids),
                "kv_traffic": e.kv_traffic(),
                "weight_traffic": e.weight_traffic()}
        finally:
            if e.paged_blocks is not None:
                e.paged_blocks.release()
            del e
    kv, pair = runs["kv"], runs["expert_kv"]
    w = pair["weight_traffic"]
    emit({"phase": "check_expert_kv", "layers": eng.cfg.num_layers,
          "engine": settings, "requests": len(prompts),
          "prompt_tokens": int(lens.sum()),
          "new_tokens_each": NEW_TOKENS // 4,
          "identical_requests": sum(a == b for a, b in
                                    zip(pair["out"], kv["out"])),
          "agree_tokens": sum(x == y for a, b in zip(pair["out"], kv["out"])
                              for x, y in zip(a, b)),
          "total_tokens": sum(len(a) for a in kv["out"]),
          "kv_traffic_equal": pair["kv_traffic"] == kv["kv_traffic"],
          "wall_s": [kv["wall_s"], pair["wall_s"]],
          "preemptions": [kv["preemptions"], pair["preemptions"]],
          "launches": pair["launches"],
          "kv_traffic": pair["kv_traffic"],
          "weight_traffic": {k: w[k] for k in (
              "hits", "misses", "prefetches", "evictions", "h2d_bytes")}})
    require(kv["done"] and pair["done"], "not every request finished")
    require(pair["out"] == kv["out"], "expert-paged + KV-paged greedy "
                                      "transcripts differ from the "
                                      "KV-paged engine's")
    require(pair["kv_traffic"] == kv["kv_traffic"],
            "expert paging changed the KV plan")
    require(pair["kv_traffic"]["spills"] > 0 and w["misses"] > 0,
            f"an offload tier was not exercised: {pair['kv_traffic']}")
    launches = pair["launches"]
    require(all(launches[k] > 0 for k in ("moe_ffn", "paged_gqa_decode",
                                          "expert_gather", "flash_prefill")),
            f"a kernel of the two-tier path never launched: {launches}")
    return launches


def host_peak_rss() -> int:
    """The process's peak resident host memory so far, in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_serve_expert(torch, np, ops):
    """mixtral-8x7b at full width through the expert-granular paged
    weights: every layer drawn on the card and written into pinned host
    stores, one layer at a time (neither the card nor pageable host memory
    ever holds the stack), served with a device pool of r_w 0.5 of the
    (layer, expert) spans.  The depth is the deepest whose stores fit
    MemAvailable with 20 % and at least 20 GiB to spare (the serve and
    its profiled window run beside the stores), never below 8.
    Returns the engine, its launches, the stores (kept for
    ``phase_serve_expert_module``) and its numbers."""
    from repro_torch.core import offload, paging
    from repro_torch.models import kvcache
    from repro_torch.models.params import (abstract_params, count_params,
                                           init_params, param_defs)
    from repro_torch.serving.engine import EngineConfig

    full = _mixtral()
    one = dataclasses.replace(full, num_layers=1)
    page_elems = EngineConfig().page_elems
    probe = paging.PagedWeights.empty(
        abstract_params(one, param_defs(one)["blocks"]), page_elems,
        torch.device("cpu"))
    per_layer = sum(t.nbytes for t in (*probe.pages.values(),
                                       *probe.expert_pages.values()))
    del probe
    # serve_expert_kv's host tier holds every KV block of every layer; the
    # pinned allocator may round each store up to twice its bytes
    kv = SERVE_EXPERT_KV
    kv_blocks = (kv["num_ubs"] * kv["ubatch"] * kv["max_seq"]
                 // kv["block_tokens"])
    kv_host = 2 * sum(a.nbytes for g in kvcache.init_paged_arena(
        one, kv_blocks, kv["block_tokens"], device="meta").values()
        for a in g.values())
    avail = host_mem_available()
    room = min(avail / HOST_MARGIN, avail - HOST_RESERVE)
    layers = min(full.num_layers, int(room // (per_layer + kv_host)))
    require(layers >= MIN_EXPERT_LAYERS,
            f"MemAvailable {avail} holds {layers} layers of {per_layer} "
            f"+ {kv_host} bytes with 20 % and 20 GiB to spare; "
            f"serve_expert needs {MIN_EXPERT_LAYERS}")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    defs = param_defs(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, g, DEVICE,
                         defs={k: v for k, v in defs.items()
                               if k != "blocks"})
    pw = paging.PagedWeights.empty(abstract_params(cfg, defs["blocks"]),
                                   page_elems, torch.device(DEVICE))
    pin_s = time.perf_counter() - t0
    one_defs = param_defs(dataclasses.replace(cfg, num_layers=1))["blocks"]
    for layer in range(layers):
        drawn = init_params(cfg, g, DEVICE, defs=one_defs)
        for key, tree in drawn.items():
            pw.write_layer(key, layer, paging.layer_slice(tree, 0))
        del drawn
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pinned = offload.pinned_bytes()
    stores = {"cfg": cfg, "params": params, "pw": pw, "layers": layers,
              "of_layers": full.num_layers, "params_count": count_params(cfg),
              "store_bytes_per_layer": per_layer,
              "kv_host_bytes_per_layer": kv_host, "mem_available": avail,
              "pinned_bytes": pinned, "pin_s": pin_s, "build_s": build_s}
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             SERVE_EXPERT, "serve_expert")
    return eng, launches, stores, res


def serve_expert_engine(torch, np, ops, stores, settings, phase):
    """An expert-paged engine over `stores` (``phase_serve_expert``'s host
    stores and resident params) with the engine settings given, serving
    ``EXPERT_REQUESTS`` seeded requests; emits the `phase` line with the
    gather's link bytes, seconds and rate."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.serving.engine import Engine, EngineConfig

    pw, page_elems = stores["pw"], EngineConfig().page_elems
    eng = Engine(stores["cfg"], stores["params"], EngineConfig(**settings),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE, paged_weights=pw)
    # the spans the gather read over the link: counted on the card, per
    # call, from the same map, sel and n_act the kernel reads; and its time
    # on the stream (its kernel to its last copy), by a pair of CUDA
    # events around each call
    host_spans = torch.zeros((), dtype=torch.int64, device=DEVICE)
    spans_timed = []
    inner = ops.expert_gather

    def counted(store, pool, rmap, layer, sel, n_act, manifest, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = inner(store, pool, rmap, layer, sel, n_act, manifest, **kw)
        ev[1].record()
        spans_timed.append(ev)
        real = torch.arange(sel.shape[0], device=DEVICE) < n_act
        host_spans.add_(((rmap[layer].index_select(0, sel.long()) < 0)
                         & real).sum())
        return out
    ops.expert_gather = counted
    try:
        _, res, outs = serve_run(torch, np, eng, ops, EXPERT_PROMPT_LENS,
                                 EXPERT_REQUESTS, SEED + 8,
                                 EXPERT_NEW_TOKENS)
    finally:
        ops.expert_gather = inner
    traffic = eng.weight_traffic()
    span = next(iter(pw.expert_manifests.values())).span_bytes
    gather_host_bytes = int(host_spans) * span
    gather_s = sum(a.elapsed_time(b) for a, b in spans_timed) / 1e3
    res.update(gather_host_bytes=gather_host_bytes,
               gather_calls=len(spans_timed), gather_s=gather_s,
               gather_host_GBps=gather_host_bytes / gather_s / 1e9,
               transcripts=outs)
    emit({"phase": phase, "model": "mixtral-8x7b",
          "layers": stores["layers"],
          "of_layers": stores["of_layers"],
          "params": stores["params_count"],
          **{k: stores[k] for k in ("store_bytes_per_layer",
                                    "kv_host_bytes_per_layer",
                                    "mem_available", "pinned_bytes", "pin_s",
                                    "build_s")},
          "pool_spans": sum(r.capacity for r in eng.residency.values()),
          "pool_bytes": sum(p.nbytes for p in eng._expert_pool.values()),
          "engine": {**settings, "page_elems": page_elems},
          **{k: v for k, v in res.items() if k != "transcripts"},
          "host_peak_rss": host_peak_rss(),
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values()),
          "weight_traffic": traffic, "kv_traffic": eng.kv_traffic()})
    require(traffic["hits"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the residency pool was not exercised: {traffic}")
    require(gather_host_bytes > 0, "the gather read nothing from the host")
    launches = res["launches"]
    decode = "paged_gqa_decode" if settings.get("kv_paged") else "gqa_decode"
    require(all(launches[k] > 0 for k in
                ("expert_gather", "moe_ffn", decode, "flash_prefill")),
            f"a kernel of the expert-paged path never launched: {launches}")
    res["weight_traffic"] = traffic
    return eng, launches, res


def phase_serve_expert_module(torch, np, ops, stores, base):
    """``serve_expert``'s stores, depth, pool ratio and requests through a
    module-batched engine (G = 2): one gather a layer a window reads each
    activated span once for both groups.  Its greedy transcripts must
    equal ``serve_expert``'s, the measured amortization
    (``module_groups_effective``) must exceed 1, and the gather must read
    fewer bytes over the link than ``serve_expert``'s."""
    settings = {**SERVE_EXPERT, "module_batch": True}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             settings, "serve_expert_module")
    traffic = eng.weight_traffic()
    emit({"phase": "serve_expert_module_vs_serve_expert",
          "identical_requests": sum(
              a == b for a, b in zip(res["transcripts"],
                                     base["transcripts"])),
          "requests_total": len(base["transcripts"]),
          "gather_host_bytes": [base["gather_host_bytes"],
                                res["gather_host_bytes"]],
          "decode_tok_per_s": [base["decode_tok_per_s"],
                               res["decode_tok_per_s"]],
          "wall_s": [base["wall_s"], res["wall_s"]],
          "module_groups_effective": traffic["module_groups_effective"]})
    require(res["transcripts"] == base["transcripts"],
            "module-batched expert-paged transcripts differ from "
            "serve_expert's")
    require(traffic["module_groups_effective"] > 1,
            f"no amortization measured: {traffic}")
    require(res["gather_host_bytes"] < base["gather_host_bytes"],
            f"the windows read no fewer bytes over the link: "
            f"{res['gather_host_bytes']} vs {base['gather_host_bytes']}")
    return eng, launches, res


def phase_serve_expert_kv(torch, np, ops, stores, module_res):
    """The paper's setting with both offload ratios: ``serve_expert``'s
    stores, depth and requests through windows at r_w 0.5 over a
    block-paged KV arena too small for the requests' rows
    (``SERVE_EXPERT_KV``), with its pinned host tier.  The arena must
    spill and fetch, the gather must read from the host, and every
    request must complete.  How many transcripts equal
    ``serve_expert_module``'s is printed, not required: a window under KV
    preemption re-admits requests, and a preemption changes who shares a
    capacity bucket."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng, launches, res = serve_expert_engine(torch, np, ops, stores,
                                             SERVE_EXPERT_KV,
                                             "serve_expert_kv")
    kv = eng.kv_traffic()
    emit({"phase": "serve_expert_kv_vs_serve_expert_module",
          "identical_requests": sum(
              a == b for a, b in zip(res["transcripts"],
                                     module_res["transcripts"])),
          "requests_total": len(module_res["transcripts"]),
          "decode_tok_per_s": [module_res["decode_tok_per_s"],
                               res["decode_tok_per_s"]],
          "prefill_s": [module_res["prefill_s"], res["prefill_s"]],
          "gather_host_bytes": [module_res["gather_host_bytes"],
                                res["gather_host_bytes"]],
          "kv_spills": kv["spills"], "kv_misses": kv["misses"],
          "preemptions": sum(r.preemptions
                             for r in eng.scheduler.requests.values())})
    require(kv["spills"] > 0 and kv["misses"] > 0,
            f"the KV host tier was not exercised: {kv}")
    return eng, launches


def host_probe(torch) -> dict:
    """Timed rates of this machine's host, for HRM's CPU level: a 1 GiB
    float32 tensor copy (bytes read + written per second) and a 4096^3
    float32 matmul (FLOP/s), each the best of 3 after a warm-up, on the
    threads PyTorch uses by default."""
    x = torch.ones(1 << 28, dtype=torch.float32)
    y = torch.empty_like(x)
    a = torch.randn(4096, 4096)
    copy_s, mm_s = [], []
    for _ in range(4):
        t = time.perf_counter()
        y.copy_(x)
        copy_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        torch.mm(a, a)
        mm_s.append(time.perf_counter() - t)
    return {"threads": torch.get_num_threads(),
            "copy_Bps": 2 * x.nbytes / min(copy_s[1:]),
            "f32_matmul_flops": 2 * 4096 ** 3 / min(mm_s[1:])}


def phase_policy(torch, records, stores, expert_res):
    """HRM's policy search for the card: the ``h100`` preset with this
    run's pinned host-to-device rate (``h2d_copy``) as its link, read
    through ``hrm.with_measured_links``, and MemAvailable (read before
    ``serve_expert`` pinned its stores) as its CPU capacity; mixtral-8x7b
    at its full 32 layers, ``kv_paged``, module groups 1 and 2, and
    ``serve_expert``'s workload (its mean prompt length, 32 new tokens).  Prints the best policy and the best with
    attention on the card (the engine runs attention there only) beside
    the r_w 0.5 set here by hand, and HRM's modelled link bytes for
    ``serve_expert``'s own settings beside what its gather moved and what
    ``weight_traffic()`` booked.  A feasible GPU-attention policy is
    required; nothing is claimed from it."""
    from repro_torch.core import hrm
    from repro_torch.core import policy as pol

    h2d = next(r for r in records if r["name"] == "expert_gather")[
        "bound_rates"]["h2d_GBps_measured"] * 1e9
    path = os.path.join(ROOT, "build", "h2d_transfer.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"h2d_pinned_bytes_per_s": h2d}, f)
    hw = hrm.with_measured_links(hrm.preset("h100"), path)
    # the host's memory before serve_expert pinned its stores
    avail = stores["mem_available"]
    hw = hrm.Hardware(tuple(dataclasses.replace(lv, capacity=float(avail))
                            if lv.name == "cpu" else lv for lv in hw.levels),
                      hw.links, name=hw.name)
    probe = host_probe(torch)
    cfg = _mixtral()
    wl = pol.Workload(round(expert_res["prompt_tokens"]
                            / expert_res["requests"]), EXPERT_NEW_TOKENS)
    t0 = time.perf_counter()
    res = pol.search(cfg, hw, wl, kv_paged=True, module_groups_grid=(1, 2))
    search_s = time.perf_counter() - t0

    def show(r):
        return None if r is None else {
            "policy": dataclasses.asdict(r["policy"]),
            **{k: r[k] for k in ("throughput", "t_layer", "t_prefill",
                                 "t_io", "t_gpu", "t_cpu", "comm_bytes",
                                 "mem_gpu", "mem_cpu")}}
    # HRM's link bytes for what serve_expert ran: one lockstep group of
    # `ubatch` rows a pass, r_w 0.5, every KV block on the card
    served = dataclasses.replace(cfg, num_layers=stores["layers"])
    ub = SERVE_EXPERT["ubatch"]
    mine = pol.Policy(ub, ub, True, True, SERVE_EXPERT["w_gpu_ratio"], 1.0)
    lat = hrm.layer_latency(hw, hrm.LayerWorkload.decode(
        served, ub, wl.avg_ctx), mine)
    traffic = expert_res["weight_traffic"]
    passes = traffic["fwd_passes"]
    gpu_attn = res["best_gpu_attn"]
    emit({"phase": "policy", "hardware": {
              "name": hw.name, "link_cpu_gpu_Bps": hw.link_bw("cpu", "gpu"),
              "levels": [dataclasses.asdict(lv) for lv in hw.levels]},
          "host_probe": probe, "workload": dataclasses.asdict(wl),
          "search_s": search_s, "best": show(res["best"]),
          "best_gpu_attn": show(gpu_attn),
          "w_gpu_ratio": {"best_gpu_attn": gpu_attn["policy"].w_gpu_ratio,
                          "set_by_hand": SERVE_EXPERT["w_gpu_ratio"]},
          "kv_gpu_ratio_best_gpu_attn": gpu_attn["policy"].kv_gpu_ratio,
          "link_bytes": {
              "modelled_per_layer_pass": lat["comm_bytes"],
              "layers": stores["layers"], "passes": passes,
              "modelled": lat["comm_bytes"] * stores["layers"] * passes,
              "gather_measured": expert_res["gather_host_bytes"],
              "booked": traffic["h2d_bytes"]}})
    require(gpu_attn is not None and gpu_attn["policy"].attn_on_gpu,
            "no feasible policy with attention on the card")


def phase_launch(torch, ops):
    """The port's serve launcher, as a user runs it, on the card:
    ``repro_torch.launch.serve --smoke --hw h100`` (HRM advice for the full
    model on the H100 preset, then synthetic requests through the engine
    on the smoke config); its JSON line must report every request done."""
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = serve.main(["--smoke", "--hw", "h100"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    emit({"phase": "launch", **res, "launches": launches})
    require(res["requests"] > 0 and res["done"] == res["requests"],
            f"the launcher left requests undone: {res}")
    require(res["device"].startswith("cuda"), "the launcher ran off the card")
    return launches


def phase_serve_mla(torch, np, ops):
    """DeepSeek-V3 at full width, 5 of its 61 layers (the 3 dense-FFN
    prologue layers and 2 MoE layers), over the block-paged latent arena
    with its pinned host tier; the prologue's latent rings stay dense."""
    from repro_torch.models.model import ExecPolicy
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = dataclasses.replace(_deepseek(), num_layers=MLA_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(SEED),
                         device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = Engine(cfg, params, EngineConfig(**SERVE_PAGED),
                 ExecPolicy(moe_impl="grouped", use_kernels=True),
                 device=DEVICE)
    prompts, res, _ = serve_run(torch, np, eng, ops, PAGED_PROMPT_LENS,
                                N_REQUESTS, SEED + 4)
    traffic = eng.kv_traffic()
    preempted = sum(r.preemptions for r in eng.scheduler.requests.values())
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    emit({"phase": "serve_mla", "model": "deepseek-v3-671b",
          "layers": MLA_LAYERS, "of_layers": _deepseek().num_layers,
          "params": count_params(cfg), "weight_bytes": weight_bytes,
          "init_s": init_s, "engine": SERVE_PAGED, **res,
          "preemptions": preempted, "arena_bytes": traffic["arena_bytes"],
          "dense_equiv_bytes": traffic["dense_equiv_bytes"],
          "h2d_bytes": traffic["h2d_bytes"],
          "d2h_bytes": traffic["d2h_bytes"], "kv_traffic": traffic})
    launches = res["launches"]
    require(traffic["spills"] > 0 and traffic["misses"] > 0
            and traffic["prefetches"] > 0,
            f"the host tier was not exercised: {traffic}")
    require(all(launches[k] > 0 for k in
                ("moe_ffn", "paged_mla_decode", "flash_prefill")),
            f"a kernel of the MLA path never launched: {launches}")
    require(launches["gqa_decode"] == launches["paged_gqa_decode"] == 0,
            f"the MLA path ran a GQA decode kernel: {launches}")
    return eng, prompts[:2], launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_check_mla(torch, np, cfg, params, prompts):
    """Prefill and decode logits of the MLA model through the kernels
    against the plain path, on the dense cache and on a paged latent arena
    with a scattered page table.  The plain path runs the attention
    kernels' plain versions and the grouped MoE's plain einsums in bf16:
    moe_ffn's plain version casts a layer's 22.5 GB of expert weights to
    f32 (45 GB), which the card cannot hold beside the model; the kernel
    phase holds moe_ffn against it at this shape."""
    from repro_torch.models import kvcache
    from repro_torch.models.model import ExecPolicy, forward, unembed
    from repro_torch.serving import steps

    pols = {"auto": ExecPolicy(moe_impl="grouped", use_kernels=True),
            "ref": ExecPolicy(moe_impl="grouped", use_kernels=False,
                              impl="ref")}
    worst = {"prefill": 0.0, "decode": 0.0, "decode_paged": 0.0}
    rng = np.random.default_rng(SEED + 6)
    for prompt in prompts:
        outs = {}
        for impl, pol in pols.items():
            cache = kvcache.init_cache(cfg, 1, SERVE_PAGED["max_seq"],
                                       device=DEVICE)
            tok = torch.as_tensor(prompt[None].astype("int32"),
                                  device=DEVICE)
            lens = torch.tensor([len(prompt)], dtype=torch.int32,
                                device=DEVICE)
            logits, cache = steps.make_prefill_fill_step(cfg, pol)(
                params, tok, cache, lens)
            outs[impl] = {"prefill": logits, "cache": cache}
        # one decode step, both paths fed the kernel path's greedy token;
        # on the paged layout both read the same arena and page table
        first = torch.argmax(outs["auto"]["prefill"], -1).to(
            torch.int32)[:, None]
        paged = paged_copy(torch, cfg, outs["auto"]["cache"], rng)
        for impl, o in outs.items():
            fwd = forward(cfg, params, first, cache=clone_cache(paged),
                          mode="decode", policy=pols[impl])
            o["decode_paged"] = unembed(cfg, params, fwd["hidden"][:, -1])
            fwd = forward(cfg, params, first, cache=o["cache"],
                          mode="decode", policy=pols[impl])
            o["decode"] = unembed(cfg, params, fwd["hidden"][:, -1])
        for key in worst:
            a, b = outs["auto"][key], outs["ref"][key]
            require(bool(torch.isfinite(a).all()) and a.shape == b.shape
                    == (1, cfg.vocab_size), f"bad MLA {key} logits")
            worst[key] = max(worst[key], max_err(a, b))
    emit({"phase": "check_mla", "prompts": len(prompts),
          "prompt_tokens": [len(p) for p in prompts],
          "max_abs_logit_diff": worst, "tol": LOGIT_TOL})
    require(all(v <= LOGIT_TOL for v in worst.values()),
            f"MLA kernel path logits differ from the plain path: {worst}")


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
    eng, prompts, launches, serve_outs = phase_serve(torch, np, ops)
    launches_module = phase_serve_module(torch, np, ops, eng.params,
                                         serve_outs, launches)
    eng_paged, launches_paged, paged_outs, paged_res = phase_serve_paged(
        torch, np, ops, eng.params)
    launches_overlap = phase_serve_overlap(torch, np, ops, eng.params,
                                           paged_outs)
    launches_budget = phase_serve_budget(torch, np, ops, eng.params,
                                         paged_res)
    phase_trace(torch, np, eng, "dense", PROMPT_LENS, 8)
    phase_trace(torch, np, eng_paged, "paged", PAGED_PROMPT_LENS, 16)
    engine_prompts, dense_runs = phase_check(torch, np, eng.cfg, eng.params,
                                             prompts, eng, eng_paged)
    phase_check_expert(torch, np, eng, engine_prompts, dense_runs)
    launches_check_kv = phase_check_expert_kv(torch, np, ops, eng)
    # the last two models each need most of the card's memory: the 4-layer
    # mixtral engines go first, then the 32-layer one with its host stores
    del eng, eng_paged
    gc.collect()
    eng_expert, launches_expert, stores, expert_res = phase_serve_expert(
        torch, np, ops)
    phase_trace(torch, np, eng_expert, "expert", EXPERT_PROMPT_LENS, 4,
                EXPERT_NEW_TOKENS // 4)
    # the stores stay pinned for the module-batched engine; the first
    # engine's device pool goes first
    del eng_expert
    gc.collect()
    eng_expert, launches_expert_module, module_res = \
        phase_serve_expert_module(torch, np, ops, stores, expert_res)
    phase_trace(torch, np, eng_expert, "expert_module", EXPERT_PROMPT_LENS,
                4, EXPERT_NEW_TOKENS // 4)
    del eng_expert
    gc.collect()
    # both offload ratios at once, over the same stores
    eng_expert, launches_expert_kv = phase_serve_expert_kv(
        torch, np, ops, stores, module_res)
    stores["pw"].release()
    del eng_expert
    gc.collect()
    phase_policy(torch, records, stores, expert_res)
    del stores
    launches_launch = phase_launch(torch, ops)
    eng_mla, mla_prompts, launches_mla = phase_serve_mla(torch, np, ops)
    phase_trace(torch, np, eng_mla, "mla", PAGED_PROMPT_LENS, 16)
    phase_check_mla(torch, np, eng_mla.cfg, eng_mla.params, mla_prompts)

    by_path = {"paged_gqa_decode": launches_paged,
               "paged_mla_decode": launches_mla,
               "expert_gather": launches_expert}
    # the launches of this slice's paths, beside each kernel's main path
    new_paths = {"serve_module": launches_module,
                 "serve_overlap": launches_overlap,
                 "serve_expert_module": launches_expert_module,
                 "serve_budget": launches_budget,
                 "check_expert_kv": launches_check_kv,
                 "serve_expert_kv": launches_expert_kv,
                 "launch": launches_launch}
    for rec in records:
        rec["launches"] = by_path.get(rec["name"], launches)[rec["name"]]
        rec["launches_by_path"] = {k: v[rec["name"]]
                                   for k, v in new_paths.items()}
        if "deepseek" in rec:
            rec["deepseek"]["launches"] = launches_mla[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "shape", "launches_by_path")
    emit({"kernels": [{**{k: r[k] for k in keys},
                       **{k: r[k] for k in ("served_occupancy", "deepseek",
                                            "full_ring")
                          if k in r}} for r in records]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
