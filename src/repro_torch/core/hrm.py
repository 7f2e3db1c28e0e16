"""Hierarchical Roofline Model (paper §3).

Extends the classical roofline (Williams et al.) to a hierarchy of memory
levels, each optionally coupled to a processor, with cross-level bandwidth
links.  Implements Eqs. (1)–(11) of the paper:

  * per-level compute roof          P_x^i <= P_peak^i                  (4)
  * per-level memory roof           P_x^i <= B_peak^i * I_x^i          (5)
  * cross-level memory roof         P_x^i <= B_peak^{j,i} * I_x^j      (6)
  * attainable perf w/ fetch        min of the three                   (7)
  * attainable perf local           min(P_peak, B*I)                   (8)
  * turning point P1 (don't move)   Ī = min(P_j, B_j I_j) / B_{j,i}    (9)
  * turning point P2 (xfer-bound)   Ī = min(P_i, B_i I_i) / B_{j,i}    (10)
  * balance point                   B_i I_i == B_{j,i} I_j             (11)

Levels are identified by name ("gpu", "cpu", "hbm", "host", ...).  The same
code produces the paper's L4/T4 analysis (Figs. 4/5/10), the JAX package's
TPU-v5e analysis and the port's H100 one (``preset("h100")``, its link
replaced by the rate measured on the card: ``with_measured_links``).

A copy of ``repro/core/hrm.py`` for the PyTorch port (pure arithmetic; the
tests hold the two equal).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Hardware description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Level:
    name: str
    p_peak: float            # FLOP/s of the processor at this level (0: none)
    b_peak: float            # local memory bandwidth, bytes/s
    capacity: float          # bytes


@dataclass(frozen=True)
class Hardware:
    """A hierarchy: levels ordered fast->slow, plus cross-level links."""
    levels: Tuple[Level, ...]
    links: Dict[Tuple[str, str], float] = field(default_factory=dict)
    name: str = "custom"

    def level(self, name: str) -> Level:
        for l in self.levels:
            if l.name == name:
                return l
        raise KeyError(name)

    def link_bw(self, src: str, dst: str) -> float:
        if (src, dst) in self.links:
            return self.links[(src, dst)]
        if (dst, src) in self.links:
            return self.links[(dst, src)]
        raise KeyError((src, dst))


# Hardware presets.  GPU/CPU numbers follow the paper's Fig. 3 / §6.3 (L4
# instance; T4 from public specs); TPU v5e numbers are the task-assigned
# constants: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI, plus an
# assumed 16 GB/s/host PCIe (8 chips/host -> 2 GB/s/chip) for host offload.
# The four are the reference's; "h100" is the port's card (see below).

# NVIDIA H100 80GB HBM3 (SXM), from its data sheet: 989 TFLOP/s dense bf16
# on the tensor cores, 3.35 TB/s HBM, 80 GB.
H100_GPU = ("gpu", 989e12, 3.35e12, 80e9)
# Placeholders that a run on the card replaces, each measured on the H100
# machine (NVIDIA H100 80GB HBM3 at 700 W, 8 host cores whose model lscpu
# does not name) by chip_smoke.py.  The link: the pinned host-to-device
# copy rate of its h2d_copy (55.2 GB/s); its policy phase swaps in its own
# run's rate (with_measured_links).  The CPU level: capacity, MemAvailable
# before the expert stores were pinned (95.4 GB; the policy phase uses its
# own run's); bandwidth and FLOP/s, timed in the policy phase (host_probe:
# a 1 GiB float32 tensor copy, 49.2 GB/s read + written, and a float32
# 4096^3 matmul, 0.762 TFLOP/s, on PyTorch's 8 threads).
H100_LINK = 55.2e9
H100_CPU = ("cpu", 0.762e12, 49.2e9, 95.4e9)

def preset(name: str) -> Hardware:
    G = 1e9
    presets = {
        "t4": Hardware(
            levels=(Level("gpu", 65e12, 300 * G, 16 * G),
                    Level("cpu", 1.6e12, 80 * G, 192 * G)),
            links={("cpu", "gpu"): 12 * G}, name="t4"),
        "l4": Hardware(
            levels=(Level("gpu", 121e12, 300 * G, 24 * G),
                    Level("cpu", 1.6e12, 80 * G, 192 * G)),
            links={("cpu", "gpu"): 25 * G}, name="l4"),
        "a100x2": Hardware(
            levels=(Level("gpu", 2 * 312e12, 2 * 2039 * G, 160 * G),
                    Level("cpu", 1.6e12, 200 * G, 1000 * G)),
            links={("cpu", "gpu"): 100 * G}, name="a100x2"),
        # TPU v5e: "gpu" = one chip; "ici" = a PEER chip's HBM (the peer has
        # its own MXU — computing where the KV shard lives is the
        # sequence-sharded decode attention of collectives.py); "cpu" = the
        # weak host over PCIe.  Task constants: 197 TF bf16, 819 GB/s HBM,
        # ~50 GB/s/link ICI; host assumed 16 GB/s per 8-chip host.
        "v5e": Hardware(
            levels=(Level("gpu", 197e12, 819 * G, 16 * G),
                    Level("ici", 197e12, 819 * G, 255 * 16 * G),
                    Level("cpu", 0.4e12, 50 * G, 256 * G)),
            links={("cpu", "gpu"): 2 * G, ("ici", "gpu"): 50 * G},
            name="v5e"),
        "h100": Hardware(
            levels=(Level(*H100_GPU), Level(*H100_CPU)),
            links={("cpu", "gpu"): H100_LINK}, name="h100"),
    }
    return presets[name]


def measured_link_bw(path: str = "BENCH_transfer.json"):
    """Measured host→device bandwidth (bytes/s) from a transfer artifact
    (a JSON object; the JAX package's benchmarks/bench_transfer.py writes
    one, and chip_smoke.py writes one from its h2d_copy): the pinned-path
    figure when the backend had a pinned host space, else the pageable
    figure.  Returns None when the artifact is absent/malformed or the run
    was on the CPU (null bandwidths there — a CPU 'transfer' is a memcpy
    and would poison the roofline)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    bw = data.get("h2d_pinned_bytes_per_s") or data.get(
        "h2d_pageable_bytes_per_s")
    return float(bw) if bw else None


def with_measured_links(hw: Hardware, path: str = "BENCH_transfer.json"
                        ) -> Hardware:
    """The roofline's cpu→gpu link term replaced by the *measured* H2D
    bandwidth when a transfer artifact is on disk — the paper's
    HRM uses spec-sheet constants, but achieved PCIe/DMA rates routinely
    sit 20–40% under spec and the T_pre/T_dec bounds inherit the error.
    No artifact → the preset is returned unchanged."""
    bw = measured_link_bw(path)
    if bw is None:
        return hw
    links = dict(hw.links)
    links[("cpu", "gpu")] = bw
    return Hardware(hw.levels, links, name=f"{hw.name}+measured")


# ---------------------------------------------------------------------------
# Roofline math
# ---------------------------------------------------------------------------

def attainable_local(hw: Hardware, level: str, intensity: float) -> float:
    """Eq. (8): performance of a computation resident at `level`."""
    l = hw.level(level)
    return min(l.p_peak, l.b_peak * intensity)


def attainable_cross(hw: Hardware, exec_level: str, data_level: str,
                     i_exec: float, i_data: float) -> float:
    """Eq. (7): executed at exec_level, data fetched from data_level."""
    l = hw.level(exec_level)
    bw = hw.link_bw(data_level, exec_level)
    return min(l.p_peak, l.b_peak * i_exec, bw * i_data)


def turning_point_p1(hw: Hardware, exec_level: str, data_level: str,
                     i_data_local: float) -> float:
    """Eq. (9): critical I below which it is better to compute at
    data_level than to move the data up to exec_level."""
    bw = hw.link_bw(data_level, exec_level)
    return attainable_local(hw, data_level, i_data_local) / bw


def turning_point_p2(hw: Hardware, exec_level: str, data_level: str,
                     i_exec_local: float) -> float:
    """Eq. (10): critical I below which the cross-level link binds."""
    bw = hw.link_bw(data_level, exec_level)
    return attainable_local(hw, exec_level, i_exec_local) / bw


def balance_point_intensity(hw: Hardware, exec_level: str, data_level: str,
                            i_exec: float) -> float:
    """Eq. (11): the I_x^j at which local and cross-level bandwidth bind
    simultaneously: B_i I_i = B_{j,i} I_j  ->  I_j = B_i I_i / B_{j,i}."""
    bw = hw.link_bw(data_level, exec_level)
    return hw.level(exec_level).b_peak * i_exec / bw


def should_compute_at_data(hw: Hardware, exec_level: str, data_level: str,
                           i_data: float) -> bool:
    """The paper's CPU-attention criterion: if the task's intensity w.r.t.
    the data level is below P1's critical intensity, don't move the data."""
    return i_data < turning_point_p1(hw, exec_level, data_level, i_data)


# ---------------------------------------------------------------------------
# LLM decode-layer workload model (paper §4.2, Table 1 notation)
# ---------------------------------------------------------------------------

@dataclass
class LayerWorkload:
    """Theoretical per-layer flops/bytes for one decode step of a batch.

    All quantities are for ONE transformer layer processing N tokens
    (batch) with average context length `ctx`.

    For MoE layers the weight bytes are split: ``bytes_w_shared``
    (attention projections + shared experts — touched every step) vs
    ``bytes_w_expert`` (the *activated* routed-expert bytes, whose H2D
    traffic the expert-granular residency cache can absorb at the
    measured/assumed ``popularity`` hit rate).  ``bytes_w`` stays their
    sum for the intensity definitions."""
    flops_attn: float        # attention score+value flops (excl. qkvo proj)
    bytes_kv: float          # KV cache bytes touched
    flops_ffn: float         # FFN (MoE) flops incl. router+shared
    bytes_w: float           # layer weight bytes (experts + attn proj)
    bytes_hidden: float      # D1/D2-class transfers: activations per ub hop
    flops_proj: float        # qkvo projection flops
    bytes_w_shared: float = 0.0   # non-routed weight bytes (= bytes_w if dense)
    bytes_w_expert: float = 0.0   # expected activated routed-expert bytes
    num_experts: int = 0          # routed expert count (0 = dense layer)
    popularity: Optional[object] = None  # (E,) or (L, E) routing frequency
    kv_hit: Optional[float] = None  # measured device-hit fraction of KV
    # block touches (core.blockpool counters); None -> the r_c-linear
    # placement assumption (resident fraction == hit fraction)
    predictor_accuracy: float = 0.0  # measured GatePredictor.acc (engine's
    # weight_traffic()['predictor_accuracy']); feeds the intra-pass
    # prefetch term of expert_hit_rate when the policy predicts

    @classmethod
    def decode(cls, cfg, batch: int, ctx: float, dtype_bytes: int = 2,
               experts_hit: Optional[float] = None, popularity=None,
               kv_hit: Optional[float] = None,
               block_tokens: Optional[int] = None,
               predictor_accuracy: float = 0.0):
        """``block_tokens``: set for the block-granular paged pool — the
        page-table-native decode kernels gather whole blocks, so the KV
        bytes touched per step round ``ctx`` up to the mapped-block
        footprint (what Engine.kv_traffic()'s gathered-bytes counters
        measure), not the raw token count."""
        h1 = cfg.d_model
        hd = cfg.head_dim or 1
        nq = max(cfg.num_heads, 1)
        nkv = max(cfg.num_kv_heads, 1)
        if cfg.kv_lora_rank:               # MLA: latent cache
            kv_row = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            flops_attn = 2 * batch * ctx * nq * (cfg.kv_lora_rank
                                                 + cfg.qk_rope_head_dim) * 2
        else:
            kv_row = 2 * nkv * hd
            flops_attn = 2 * batch * ctx * nq * hd * 2
        kv_ctx = ctx
        if block_tokens:
            kv_ctx = block_tokens * math.ceil(ctx / block_tokens)
        bytes_kv = batch * kv_ctx * kv_row * dtype_bytes

        w_expert = 0.0
        num_experts = 0
        if cfg.is_moe:
            k = cfg.top_k + cfg.num_shared_experts
            f_flops = 2 * 3 * h1 * cfg.d_ff * k * batch
            n_hit = experts_hit if experts_hit is not None else min(
                cfg.num_experts, batch * cfg.top_k)
            w_ffn = (n_hit + cfg.num_shared_experts) * 3 * h1 * cfg.d_ff
            w_expert = n_hit * 3 * h1 * cfg.d_ff
            num_experts = cfg.num_experts
        else:
            f_flops = 2 * 3 * h1 * (cfg.d_ff or cfg.ssm_expand * h1) * batch
            w_ffn = 3 * h1 * (cfg.d_ff or cfg.ssm_expand * h1)
        w_attn = (2 * h1 * nq * hd + 2 * h1 * nkv * hd) if nq else 0
        flops_proj = 2 * w_attn * batch
        bytes_w = (w_ffn + w_attn) * dtype_bytes
        return cls(flops_attn=flops_attn, bytes_kv=bytes_kv, flops_ffn=f_flops,
                   bytes_w=bytes_w,
                   bytes_hidden=2 * batch * h1 * dtype_bytes,
                   flops_proj=flops_proj,
                   bytes_w_shared=bytes_w - w_expert * dtype_bytes,
                   bytes_w_expert=w_expert * dtype_bytes,
                   num_experts=num_experts, popularity=popularity,
                   kv_hit=kv_hit, predictor_accuracy=predictor_accuracy)

    # Operational intensities (paper Definition 3.1)
    def intensity_attn_vs_kv(self) -> float:
        return self.flops_attn / max(self.bytes_kv, 1.0)

    def intensity_ffn_vs_weights(self) -> float:
        return self.flops_ffn / max(self.bytes_w, 1.0)


def kv_block_hit_rate(kv_gpu_ratio: float, num_ubs: int = 1) -> float:
    """Expected device-hit fraction of a decode step's KV block touches
    under the block-granular paged cache with CGOPipe rotation.

    The arena holds ``r_c`` of the total KV blocks, but only the decoding
    group's blocks — ``1/num_ubs`` of the total — are touched per step,
    so the fraction of the active working set still resident when its
    turn comes back around is ``min(1, r_c · num_ubs)`` under fair
    (oldest-first) spilling.  ``num_ubs = 1`` degenerates to the dense
    placement assumption hit = r_c; rotation is exactly what makes a
    small arena disproportionately effective — the same shape as
    ``expert_hit_rate`` for skewed routing.  KV traffic per layer is then
    ``miss_rate × touched block bytes`` (each transfer moves whole
    blocks, which is what the engine's BlockPool counters measure).
    Since the page-table-native decode kernels gather exactly the mapped
    blocks (``Engine.kv_traffic()``'s gathered-bytes/step), this modeled
    term now matches what the device executes — pass
    ``LayerWorkload.decode(..., block_tokens=…)`` so the touched bytes
    round to whole blocks too."""
    r = min(max(kv_gpu_ratio, 0.0), 1.0)
    return float(min(1.0, r * max(1, num_ubs)))


def _top_mass(p, slots: float, num_experts: int) -> float:
    """Retained routing mass when the hottest ``slots`` experts (fractional
    slots prorated) of a normalized (rows, E) popularity matrix are
    resident; averaged over rows."""
    k = int(slots)
    frac = slots - k
    srt = np.sort(p, axis=1)[:, ::-1]
    hit = srt[:, :k].sum(axis=1)
    if k < num_experts:
        hit = hit + frac * srt[:, k]
    return float(np.clip(hit.mean(), 0.0, 1.0))


def expert_hit_rate(w_gpu_ratio: float, num_experts: int,
                    popularity=None, predictor_accuracy: float = 0.0,
                    predict_lookahead: int = 0,
                    replicate_frac: Optional[float] = None) -> float:
    """Expected P(activated expert span is on-device when its layer
    dispatches) under the residency cache (core.residency) with a pool
    sized by the policy's ``r_w``.

    Uniform routing → exactly ``r_w`` (the whole-layer model's implicit
    assumption).  A measured popularity vector — (E,) or per-layer
    (L, E), e.g. the residency EWMA table — → the retained top mass,
    which is ≥ r_w: skewed routing makes a small cache disproportionately
    effective, and this is precisely what lets the policy search trade
    ``r_w`` against hit rate instead of against raw resident bytes.

    ``replicate_frac`` (None = no replication, legacy model): a fraction
    of the ``r_w·E`` slots is pinned persistently to the popularity-top
    experts (hysteresis keeps them through window turnover), whose mass
    always hits; the remaining non-pinned slots are modeled
    conservatively as a uniform share of the residual mass — pinning
    guarantees the head of the distribution at the cost of popularity
    targeting in the tail, which is the trade ``policy.search`` sweeps.

    ``predictor_accuracy`` (GatePredictor.acc) with
    ``predict_lookahead ≥ 1``: intra-pass predicted prefetch converts a
    would-be miss into a hit when the predictor called the expert and the
    span landed in time — modeled as acc discounted by ℓ/(ℓ+1) (a
    1-layer lookahead hides only spans whose transfer fits one layer's
    compute; deeper lookahead approaches full overlap)."""
    r = min(max(w_gpu_ratio, 0.0), 1.0)
    if num_experts <= 0:
        return r
    if popularity is None:
        p = np.full((1, num_experts), 1.0 / num_experts)
    else:
        p = np.atleast_2d(np.asarray(popularity, float))
        sums = p.sum(axis=1, keepdims=True)
        uniform = np.full_like(p, 1.0 / num_experts)
        p = np.where(sums > 0, p / np.maximum(sums, 1e-30), uniform)
    slots = r * num_experts
    if replicate_frac is None:
        hit = r if popularity is None else _top_mass(p, slots, num_experts)
    else:
        rf = min(max(float(replicate_frac), 0.0), 1.0)
        rep_slots = rf * slots
        m_rep = _top_mass(p, rep_slots, num_experts)
        rest_experts = max(num_experts - rep_slots, 1e-9)
        hit_rest = (1.0 - m_rep) * min(1.0, (slots - rep_slots)
                                       / rest_experts)
        hit = min(1.0, m_rep + hit_rest)
    acc = min(max(float(predictor_accuracy), 0.0), 1.0)
    la = max(int(predict_lookahead), 0)
    if acc > 0.0 and la > 0:
        hit = hit + (1.0 - hit) * acc * (la / (la + 1.0))
    return float(np.clip(hit, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Paper-style per-layer latency estimate (Eqs. 12–14)
# ---------------------------------------------------------------------------

def time_comp(flops: float, p_peak: float) -> float:
    return flops / p_peak if p_peak > 0 else float("inf")


def time_comm(bytes_: float, bw: float) -> float:
    return bytes_ / bw if bw > 0 else float("inf")


def layer_latency(hw: Hardware, wl: LayerWorkload, policy) -> Dict[str, float]:
    """T = max(comm_cpu_to_gpu, T_cpu, T_gpu) — Eq. (12) with Eq. (13)/(14).

    `policy` needs fields: attn_on_gpu (A_g), ffn_on_gpu (F_g),
    w_gpu_ratio (r_w), kv_gpu_ratio (r_c).
    """
    gpu, cpu = hw.level("gpu"), hw.level("cpu")
    b_cg = hw.link_bw("cpu", "gpu")

    comm_ctg = 0.0           # CPU->GPU transferred bytes per layer
    t_gpu = t_cpu = 0.0

    # ---- attention ----
    if policy.attn_on_gpu:
        # KV traffic term: miss rate × touched KV bytes.  The default
        # (kv_hit = r_c) is the dense placement assumption — a fixed r_c
        # fraction resident; a measured/modelled block hit rate (paged
        # pool, kv_block_hit_rate) lets the search trade r_c against r_w
        # on the same link budget.
        kv_hit = wl.kv_hit if wl.kv_hit is not None else policy.kv_gpu_ratio
        kv_from_cpu = wl.bytes_kv * (1 - kv_hit)
        comm_ctg += kv_from_cpu
        t_attn = max(time_comp(wl.flops_attn, gpu.p_peak),
                     time_comm(wl.bytes_kv * kv_hit, gpu.b_peak)
                     + time_comm(kv_from_cpu, b_cg))
        t_gpu += t_attn
    else:
        t_attn = max(time_comp(wl.flops_attn, cpu.p_peak),
                     time_comm(wl.bytes_kv, cpu.b_peak))
        t_cpu += t_attn
        comm_ctg += wl.bytes_hidden      # D2: hidden states back to GPU

    # ---- FFN ----
    if policy.ffn_on_gpu:
        # module-based batching (policy.module_groups = G > 1): each
        # streamed weight span serves G rotation groups' staged tokens
        # per accumulation window, so per-layer-pass weight traffic
        # amortizes by 1/G.  The staging-buffer memory this buys is
        # charged in policy.memory_usage, so the search trades the two
        # on one budget.
        mg = max(1, int(getattr(policy, "module_groups", 1) or 1))
        if wl.num_experts and wl.bytes_w_expert:
            # expert-granular paging: the shared span streams at (1-r_w)
            # as before, but the routed-expert traffic is *expected
            # activated bytes × miss rate* — the residency cache absorbs
            # the hits, so r_w buys hit rate, not just resident bytes
            hit = expert_hit_rate(
                policy.w_gpu_ratio, wl.num_experts, wl.popularity,
                predictor_accuracy=wl.predictor_accuracy,
                predict_lookahead=getattr(policy, "predict_lookahead", 0),
                replicate_frac=getattr(policy, "replicate_frac", None))
            w_from_cpu = (wl.bytes_w_shared * (1 - policy.w_gpu_ratio)
                          + wl.bytes_w_expert * (1 - hit)) / mg
        else:
            w_from_cpu = wl.bytes_w * (1 - policy.w_gpu_ratio) / mg
        comm_ctg += w_from_cpu
        t_ffn = max(time_comp(wl.flops_ffn + wl.flops_proj, gpu.p_peak),
                    time_comm(wl.bytes_w, gpu.b_peak))
        t_gpu += t_ffn
    else:
        t_ffn = max(time_comp(wl.flops_ffn + wl.flops_proj, cpu.p_peak),
                    time_comm(wl.bytes_w, cpu.b_peak))
        t_cpu += t_ffn

    t_io = time_comm(comm_ctg, b_cg)
    return {"t_layer": max(t_io, t_cpu, t_gpu), "t_io": t_io,
            "t_cpu": t_cpu, "t_gpu": t_gpu, "comm_bytes": comm_ctg}
