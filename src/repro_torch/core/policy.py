"""Policy search (paper §4.2).

Searches the 6-tuple P = (N, μ, A_g, F_g, r_w, r_c) minimizing estimated
per-layer decode latency T(M, H, W, P) = max(comm_cpu→gpu, T_cpu, T_gpu)
subject to GPU and CPU memory capacities — i.e. drives the system to the
HRM balance point (Eq. 11).  The paper solves a MILP; the space is small
enough for exact enumeration (no solver dependency offline), finishing in
well under the paper's "less than a minute".

A copy of ``repro/core/policy.py`` for the PyTorch port, counting
parameters with the port's ``count_params`` (the tests hold the two
equal, and the searches to the same policies).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hrm as H
from repro_torch.models.params import count_params


@dataclass(frozen=True)
class Policy:
    """The paper's Table-1 policy tuple (+ derived batching plan)."""
    batch: int               # N — tokens per model pass
    ubatch: int              # μ — tokens per kernel execution
    attn_on_gpu: bool        # A_g
    ffn_on_gpu: bool         # F_g
    w_gpu_ratio: float       # r_w — weights resident on GPU
    kv_gpu_ratio: float      # r_c — KV cache resident on GPU
    # module-based batching: rotation groups accumulated per expert-phase
    # window (1 = lockstep attention/FFN, the classic CGOPipe schedule).
    # Each streamed weight span then serves G groups' staged tokens, so
    # the HRM weight-traffic term amortizes by 1/G at the cost of a
    # G-deep routed-token staging buffer (memory_usage charges it).
    module_groups: int = 1
    # intra-pass predictive prefetch: layers of gate-predictor lookahead
    # (0 = off).  ℓ ≥ 1 lets predicted spans stream while earlier layers
    # compute (expert_hit_rate's predictor term), at the cost of an
    # ℓ-deep in-flight span staging charge (memory_usage).
    predict_lookahead: int = 0
    # hot-expert replication: fraction of the r_w·E residency slots
    # pinned persistently to the popularity-top experts (None = no
    # replication — the legacy pure-LRU/EWMA model).
    replicate_frac: Optional[float] = None

    @property
    def num_ubs(self) -> int:
        return max(1, self.batch // self.ubatch)


@dataclass(frozen=True)
class Workload:
    """Paper Table 1: s (avg prompt len), n (generation length)."""
    prompt_len: int
    gen_len: int

    @property
    def avg_ctx(self) -> float:
        return self.prompt_len + self.gen_len / 2


# ---------------------------------------------------------------------------
# Memory accounting
# ---------------------------------------------------------------------------

def model_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    return count_params(cfg) * dtype_bytes


def kv_bytes_per_token_layer(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    if cfg.kv_lora_rank:
        return (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * dtype_bytes
    if cfg.num_kv_heads == 0:      # SSM: O(1) state, charge nothing per token
        return 0.0
    return 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes


def memory_usage(cfg: ModelConfig, wl: Workload, pol: Policy,
                 dtype_bytes: int = 2) -> Dict[str, float]:
    W_total = model_bytes(cfg, dtype_bytes)
    W_layer = W_total / max(cfg.num_layers, 1)
    kv_total = (kv_bytes_per_token_layer(cfg, dtype_bytes) * cfg.num_layers
                * pol.batch * (wl.prompt_len + wl.gen_len))
    act = pol.ubatch * cfg.d_model * dtype_bytes
    gpu = (pol.w_gpu_ratio * W_total
           + pol.kv_gpu_ratio * kv_total
           + 2 * (1 - pol.w_gpu_ratio) * W_layer       # 2x page buffer (A.1)
           + 8 * act)                                  # in-flight activations
    mg = max(1, int(getattr(pol, "module_groups", 1) or 1))
    if mg > 1:
        # module-based batching: the routed-token staging buffer holds
        # every group's top-k expanded activations for the layer being
        # executed (gather input + scatter output, hence the 2×)
        gpu += 2 * mg * pol.ubatch * max(cfg.top_k, 1) * cfg.d_model \
            * dtype_bytes
    la = max(0, int(getattr(pol, "predict_lookahead", 0) or 0))
    if la > 0 and cfg.is_moe:
        # predicted spans stream ahead of their layer: up to ℓ layers ×
        # top-k expert spans are in flight (pinned, not yet chargeable to
        # the resident pool) at any point of the pass
        gpu += la * max(cfg.top_k, 1) * 3 * cfg.d_model * (cfg.d_ff or 0) \
            * dtype_bytes
    if pol.attn_on_gpu:
        gpu += (1 - pol.kv_gpu_ratio) * kv_total / max(cfg.num_layers, 1) * 2
    cpu = ((1 - pol.w_gpu_ratio) * W_total
           + (1 - pol.kv_gpu_ratio) * kv_total
           + 4 * (1 - pol.w_gpu_ratio) * W_layer       # pinned staging
           + 8 * act)
    return {"gpu": gpu, "cpu": cpu, "kv_total": kv_total, "w_total": W_total}


# ---------------------------------------------------------------------------
# Throughput estimate
# ---------------------------------------------------------------------------

def estimate(cfg: ModelConfig, hw: H.Hardware, wl: Workload, pol: Policy,
             dtype_bytes: int = 2, expert_popularity=None,
             kv_hit_rate: Optional[float] = None,
             kv_paged: bool = False,
             block_tokens: Optional[int] = None,
             predictor_accuracy: float = 0.0) -> Dict[str, float]:
    """Per-layer decode latency (Eq. 12) and end-to-end generation
    throughput (tokens/s) including prefill amortization.

    expert_popularity: optional measured routing-frequency table ((E,) or
    (L, E), e.g. core.residency's EWMA) — MoE weight traffic then uses
    expected activated-expert bytes × miss rate of the r_w-sized resident
    cache (H.expert_hit_rate) instead of the uniform (1 - r_w) stream.

    kv_hit_rate: optional measured device-hit fraction of KV block
    touches (core.blockpool counters) — the attention traffic term then
    becomes miss rate × touched block bytes instead of the r_c-linear
    stream.  kv_paged=True models the block-granular pool instead:
    H.kv_block_hit_rate(r_c, num_ubs) — rotation makes a small arena
    disproportionately effective, so the search can trade r_c down and
    spend the memory on r_w.

    block_tokens: block size of the paged pool — the page-table-native
    decode kernels gather whole blocks, so the touched-KV term rounds
    the context up to the mapped-block footprint (matching the engine's
    gathered-bytes counters).

    predictor_accuracy: measured GatePredictor accuracy (the engine's
    weight_traffic()['predictor_accuracy']) — with
    pol.predict_lookahead ≥ 1 the expert-traffic term credits intra-pass
    predicted prefetch (H.expert_hit_rate's predictor term)."""
    kv_hit = kv_hit_rate
    if kv_hit is None and kv_paged:
        kv_hit = H.kv_block_hit_rate(pol.kv_gpu_ratio, pol.num_ubs)
    lw = H.LayerWorkload.decode(cfg, pol.batch, wl.avg_ctx, dtype_bytes,
                                popularity=expert_popularity,
                                kv_hit=kv_hit, block_tokens=block_tokens,
                                predictor_accuracy=predictor_accuracy)
    lat = H.layer_latency(hw, lw, pol)
    t_layer = lat["t_layer"]
    # prefill: compute-bound on the accelerator, overlapped with weight
    # streaming (paper §4: zig-zag order, no extra optimization)
    gpu = hw.level("gpu")
    n_active = count_params(cfg, active_only=True)
    pf_flops = 2 * n_active * pol.batch * wl.prompt_len
    w_stream = (1 - pol.w_gpu_ratio) * model_bytes(cfg, dtype_bytes)
    t_prefill = max(pf_flops / gpu.p_peak,
                    w_stream / hw.link_bw("cpu", "gpu"))
    t_decode = wl.gen_len * cfg.num_layers * t_layer
    thr = pol.batch * wl.gen_len / (t_prefill + t_decode)
    return {"throughput": thr, "t_layer": t_layer, "t_prefill": t_prefill,
            **{k: v for k, v in lat.items() if k != "t_layer"}}


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def search(cfg: ModelConfig, hw: H.Hardware, wl: Workload,
           dtype_bytes: int = 2,
           ub_grid=(4, 8, 16, 32, 36, 64, 100, 128, 256),
           mult_grid=(1, 2, 4, 8, 15, 16, 26, 32, 61, 64, 92, 128, 256),
           ratio_grid=(0.0, 0.1, 0.2, 0.25, 0.5, 0.75, 0.9, 1.0),
           expert_popularity=None, kv_paged: bool = False,
           block_tokens: Optional[int] = None,
           module_groups_grid=(1,),
           predict_grid=(0,), replicate_grid=(None,),
           predictor_accuracy: float = 0.0,
           bench_path: Optional[str] = None) -> Dict:
    """Exact enumeration over the 6-tuple.  Returns the best feasible
    policy and its estimate; also the best with attention forced to each
    device (for the §6.3-style case study).

    With ``expert_popularity`` (a measured routing-frequency table), the
    MoE weight-traffic term becomes expected activated-expert bytes ×
    residency miss rate, so the search genuinely trades r_w against hit
    rate — skewed routing shifts the optimum toward smaller r_w.

    With ``kv_paged`` the KV traffic term models the block-granular
    paged pool (H.kv_block_hit_rate): rotation over num_ubs groups means
    an arena of r_c × total blocks serves ~min(1, r_c·num_ubs) of each
    step's touches from device, so smaller r_c stays feasible at the
    same latency and the freed memory can buy r_w — the search trades
    the two on one budget.

    ``module_groups_grid`` widens the search over module-based batching
    (decoupled attention/expert phases, MoE-Gen direction): G > 1
    amortizes the weight-traffic term by 1/G at the cost of a staging
    buffer (memory_usage).  The default grid (1,) keeps the classic
    lockstep search — opt in with e.g. ``module_groups_grid=(1, 2, 4)``;
    G is capped at num_ubs (there must be G groups to accumulate).

    ``predict_grid`` / ``replicate_grid`` widen the search over the
    intra-pass prediction + replication layer: lookahead ℓ credits the
    expert-traffic term with predicted-prefetch hits (discounted by the
    measured ``predictor_accuracy``) but charges an ℓ-deep in-flight
    span staging buffer; replicate_frac pins top-mass persistently at
    the cost of popularity targeting in the tail — the search trades
    both against r_w/r_c on the same memory budget.  Defaults keep the
    legacy search; opt in with e.g. ``predict_grid=(0, 1, 2),
    replicate_grid=(None, 0.25, 0.5)``."""
    if bench_path is not None:
        # swap the spec-sheet cpu↔gpu link for the measured H2D bandwidth
        # (a transfer artifact, see hrm.measured_link_bw) before enumerating — the
        # whole search then optimizes against achieved, not nominal, DMA
        hw = H.with_measured_links(hw, bench_path)
    gpu_cap = hw.level("gpu").capacity
    cpu_cap = hw.level("cpu").capacity
    best: Optional[Dict] = None
    best_by_ag = {0: None, 1: None}

    for ub, mult, ag, fg in itertools.product(
            ub_grid, mult_grid, (False, True), (True, False)):
        N = ub * mult
        for rw in (ratio_grid if fg else (0.0,)):
            for rc in (ratio_grid if ag else (0.0,)):
                for mg, la, rf in itertools.product(
                        module_groups_grid if fg else (1,),
                        predict_grid if fg else (0,),
                        replicate_grid if fg else (None,)):
                    if mg > max(1, N // ub):
                        continue
                    pol = Policy(N, ub, ag, fg, rw, rc, module_groups=mg,
                                 predict_lookahead=la, replicate_frac=rf)
                    mem = memory_usage(cfg, wl, pol, dtype_bytes)
                    if mem["gpu"] > gpu_cap or mem["cpu"] > cpu_cap:
                        continue
                    est = estimate(cfg, hw, wl, pol, dtype_bytes,
                                   expert_popularity=expert_popularity,
                                   kv_paged=kv_paged,
                                   block_tokens=block_tokens,
                                   predictor_accuracy=predictor_accuracy)
                    cand = {"policy": pol, **est, "mem_gpu": mem["gpu"],
                            "mem_cpu": mem["cpu"]}
                    if best is None or cand["throughput"] > best["throughput"]:
                        best = cand
                    key = int(ag)
                    if (best_by_ag[key] is None
                            or cand["throughput"]
                            > best_by_ag[key]["throughput"]):
                        best_by_ag[key] = cand
    if best is None:
        raise RuntimeError("no feasible policy (model too large for CPU+GPU)")
    return {"best": best, "best_gpu_attn": best_by_ag[1],
            "best_cpu_attn": best_by_ag[0]}
