"""CGOPipe and the baseline schedules (paper §4.1, Fig. 6, Algorithm 1),
validated by an event-driven pipeline simulator.

The simulator models the four contended resources of the paper's node —
GPU, CPU, H2D link, D2H link (opposite PCIe directions are independent;
same-direction transfers serialize), plus the CPU→pinned staging copier —
and executes a task DAG with resource exclusivity.  Task durations come
from the HRM performance model, so the simulator's steady-state per-layer
latency is directly comparable with `policy.estimate`.

Schedules implemented (Fig. 6):
  cgopipe    — Algorithm 1: CPU attention, paged weights interleaved with
               hidden-state transfers, j+2 lookahead.
  s2         — FastDecode-style: CPU attention overlapped, but weights
               transferred as one block (no paging).
  s3         — FlexGen(c): CPU attention, serialized per micro-batch.
  s4         — FlexGen: GPU attention with KV-cache prefetch.
  deepspeed  — whole-weight streaming, GPU attention, single micro-batch.

A copy of ``repro/core/cgopipe.py`` for the PyTorch port (a pure-Python
simulator; the tests hold the two equal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core import hrm as H

RESOURCES = ("gpu", "cpu", "h2d", "d2h", "c2p")


@dataclass
class Task:
    tid: str
    resource: str
    duration: float
    deps: Tuple[str, ...] = ()


@dataclass
class ScheduleResult:
    makespan: float
    busy: Dict[str, float]
    starts: Dict[str, float]
    ends: Dict[str, float]

    def utilization(self, resource: str) -> float:
        return self.busy.get(resource, 0.0) / self.makespan if self.makespan else 0.0

    def bubble_fraction(self, resource: str) -> float:
        return 1.0 - self.utilization(resource)


def simulate(tasks: List[Task]) -> ScheduleResult:
    """List scheduler: tasks are issued in list order per resource (the
    launch order of Algorithm 1); a task starts when its resource is free
    AND its deps have finished."""
    res_free = {r: 0.0 for r in RESOURCES}
    busy = {r: 0.0 for r in RESOURCES}
    ends: Dict[str, float] = {}
    starts: Dict[str, float] = {}
    pending = list(tasks)
    # iterate until all scheduled; list order = priority within a resource
    progressed = True
    while pending and progressed:
        progressed = False
        for t in list(pending):
            if all(d in ends for d in t.deps):
                start = max(res_free[t.resource],
                            max((ends[d] for d in t.deps), default=0.0))
                ends[t.tid] = start + t.duration
                starts[t.tid] = start
                res_free[t.resource] = ends[t.tid]
                busy[t.resource] += t.duration
                pending.remove(t)
                progressed = True
    if pending:
        raise ValueError(f"cyclic or dangling deps: {[t.tid for t in pending]}")
    makespan = max(ends.values(), default=0.0)
    return ScheduleResult(makespan, busy, starts, ends)


# ---------------------------------------------------------------------------
# Task-time model for one decode step
# ---------------------------------------------------------------------------

@dataclass
class StepTimes:
    """Durations (seconds) of the primitive tasks for ONE micro-batch at
    ONE layer.  Built by `times_from_policy`."""
    preattn: float           # GPU: LN + QKV projection (μ tokens)
    postattn: float          # GPU: O proj + (MoE) FFN (μ tokens)
    cpuattn: float           # CPU: softmax(QK)V against CPU-resident KV
    gpuattn: float           # GPU: attention if A_g=1 (compute only)
    offqkv: float            # D2H: QKV for one micro-batch
    loadh: float             # H2D: hidden states for one micro-batch
    kvload: float            # H2D: KV cache for one micro-batch (S4)
    wpage: float             # H2D: ONE page of the next layer's weights
    wfull: float             # H2D: next layer's full streamed weights
    wstage: float            # CPU→pinned staging copy of one page
    n_ubs: int = 4


def times_from_policy(cfg, hw, wl, pol, dtype_bytes: int = 2) -> StepTimes:
    gpu, cpu = hw.level("gpu"), hw.level("cpu")
    b_cg = hw.link_bw("cpu", "gpu")
    lw = H.LayerWorkload.decode(cfg, pol.ubatch, wl.avg_ctx, dtype_bytes)
    lw_full = H.LayerWorkload.decode(cfg, pol.batch, wl.avg_ctx, dtype_bytes)
    n_ubs = pol.num_ubs
    w_stream = (1 - pol.w_gpu_ratio) * lw_full.bytes_w
    hidden = pol.ubatch * cfg.d_model * dtype_bytes
    qkv = hidden * 3
    return StepTimes(
        preattn=(lw.flops_proj * 0.75) / gpu.p_peak,
        postattn=max((lw.flops_ffn + lw.flops_proj * 0.25) / gpu.p_peak,
                     lw_full.bytes_w / n_ubs / gpu.b_peak),
        cpuattn=max(lw.flops_attn / cpu.p_peak, lw.bytes_kv / cpu.b_peak),
        gpuattn=lw.flops_attn / gpu.p_peak,
        offqkv=qkv / b_cg,
        loadh=hidden / b_cg,
        kvload=lw.bytes_kv * (1 - pol.kv_gpu_ratio) / b_cg,
        wpage=w_stream / n_ubs / b_cg,
        wfull=w_stream / b_cg,
        wstage=w_stream / n_ubs / cpu.b_peak,
        n_ubs=n_ubs,
    )


# ---------------------------------------------------------------------------
# Schedule builders.  All build `n_layers` of steady-state decode.
# ---------------------------------------------------------------------------

def build_cgopipe(t: StepTimes, n_layers: int) -> List[Task]:
    """Algorithm 1 with the j+2 lookahead and paged weights."""
    tasks: List[Task] = []
    J = t.n_ubs

    def seq(i, j):           # global micro-batch sequence index
        return i * J + j

    # prologue (layer 0, first two micro-batches through the CPU side)
    for j in range(min(2, J)):
        tasks += [
            Task(f"pre_{0}_{j}", "gpu", t.preattn),
            Task(f"off_{0}_{j}", "d2h", t.offqkv, (f"pre_{0}_{j}",)),
            Task(f"cpu_{0}_{j}", "cpu", t.cpuattn, (f"off_{0}_{j}",)),
            Task(f"stage_{1}_{j}", "c2p", t.wstage),
        ]
    for i in range(n_layers):
        for j in range(J):
            deps_post = [f"load_{i}_{j}"]
            if i > 0:        # all pages of layer i must have arrived
                deps_post += [f"wpg_{i}_{k}" for k in range(J)]
            tasks += [
                Task(f"load_{i}_{j}", "h2d", t.loadh, (f"cpu_{i}_{j}",)),
                Task(f"wpg_{i + 1}_{j}", "h2d", t.wpage,
                     (f"stage_{i + 1}_{j}",)),
                Task(f"post_{i}_{j}", "gpu", t.postattn, tuple(deps_post)),
            ]
            # two micro-batches ahead (wraps into the next layer)
            a = seq(i, j) + 2
            ai, aj = a // J, a % J
            if ai < n_layers:
                dep_pre = (f"post_{ai - 1}_{aj}",) if ai > 0 else ()
                tasks += [
                    Task(f"pre_{ai}_{aj}", "gpu", t.preattn, dep_pre),
                    Task(f"off_{ai}_{aj}", "d2h", t.offqkv,
                         (f"pre_{ai}_{aj}",)),
                    Task(f"cpu_{ai}_{aj}", "cpu", t.cpuattn,
                         (f"off_{ai}_{aj}",)),
                ]
                if ai + 1 <= n_layers:
                    tasks.append(Task(f"stage_{ai + 1}_{aj}", "c2p", t.wstage))
    return tasks


def build_s2(t: StepTimes, n_layers: int) -> List[Task]:
    """CPU attention overlapped, but un-paged weight transfer: the whole
    next-layer block occupies H2D before hidden states can return."""
    tasks: List[Task] = []
    J = t.n_ubs
    for j in range(J):
        tasks += [Task(f"pre_{0}_{j}", "gpu", t.preattn),
                  Task(f"off_{0}_{j}", "d2h", t.offqkv, (f"pre_{0}_{j}",)),
                  Task(f"cpu_{0}_{j}", "cpu", t.cpuattn, (f"off_{0}_{j}",))]
    for i in range(n_layers):
        tasks.append(Task(f"wfull_{i + 1}", "h2d", t.wfull))
        for j in range(J):
            deps_post = [f"load_{i}_{j}"]
            if i > 0:
                deps_post.append(f"wfull_{i}")
            tasks += [
                Task(f"load_{i}_{j}", "h2d", t.loadh, (f"cpu_{i}_{j}",)),
                Task(f"post_{i}_{j}", "gpu", t.postattn, tuple(deps_post)),
            ]
            if i + 1 < n_layers:
                tasks += [
                    Task(f"pre_{i + 1}_{j}", "gpu", t.preattn,
                         (f"post_{i}_{j}",)),
                    Task(f"off_{i + 1}_{j}", "d2h", t.offqkv,
                         (f"pre_{i + 1}_{j}",)),
                    Task(f"cpu_{i + 1}_{j}", "cpu", t.cpuattn,
                         (f"off_{i + 1}_{j}",)),
                ]
    return tasks


def build_s3(t: StepTimes, n_layers: int) -> List[Task]:
    """FlexGen(c): CPU attention with NO lookahead — pre/off/cpu/load/post
    serialize per micro-batch (the paper's least-optimized schedule)."""
    tasks: List[Task] = []
    J = t.n_ubs
    prev = None
    for i in range(n_layers):
        tasks.append(Task(f"wfull_{i + 1}", "h2d", t.wfull))
        for j in range(J):
            deps = [prev] if prev else []
            if i > 0:
                deps.append(f"wfull_{i}")
            tasks += [
                Task(f"pre_{i}_{j}", "gpu", t.preattn, tuple(deps)),
                Task(f"off_{i}_{j}", "d2h", t.offqkv, (f"pre_{i}_{j}",)),
                Task(f"cpu_{i}_{j}", "cpu", t.cpuattn, (f"off_{i}_{j}",)),
                Task(f"load_{i}_{j}", "h2d", t.loadh, (f"cpu_{i}_{j}",)),
                Task(f"post_{i}_{j}", "gpu", t.postattn, (f"load_{i}_{j}",)),
            ]
            prev = f"post_{i}_{j}"
    return tasks


def build_s4(t: StepTimes, n_layers: int) -> List[Task]:
    """FlexGen: GPU attention, KV prefetched one micro-batch ahead,
    whole-block weight transfer."""
    tasks: List[Task] = []
    J = t.n_ubs
    tasks.append(Task("kv_0_0", "h2d", t.kvload))
    for i in range(n_layers):
        tasks.append(Task(f"wfull_{i + 1}", "h2d", t.wfull))
        for j in range(J):
            deps = [f"kv_{i}_{j}"]
            if i > 0:
                deps.append(f"wfull_{i}")
            if i or j:
                prev = (i, j - 1) if j else (i - 1, J - 1)
                deps.append(f"comp_{prev[0]}_{prev[1]}")
            tasks.append(Task(f"comp_{i}_{j}", "gpu",
                              t.preattn + t.gpuattn + t.postattn, tuple(deps)))
            nxt = (i, j + 1) if j + 1 < J else (i + 1, 0)
            if nxt[0] < n_layers:
                tasks.append(Task(f"kv_{nxt[0]}_{nxt[1]}", "h2d", t.kvload))
    return tasks


def build_deepspeed(t: StepTimes, n_layers: int) -> List[Task]:
    """ZeRO-Inference-style: stream whole weights per layer, GPU attention,
    one (big) micro-batch, no prefetch beyond the weight stream."""
    tasks: List[Task] = []
    for i in range(n_layers):
        deps = [f"w_{i}"]
        if i:
            deps.append(f"comp_{i - 1}")
        tasks.append(Task(f"w_{i}", "h2d", t.wfull * 1.0))
        tasks.append(Task(
            f"comp_{i}", "gpu",
            (t.preattn + t.gpuattn + t.postattn + t.kvload * 0) * t.n_ubs,
            tuple(deps)))
    return tasks


BUILDERS = {"cgopipe": build_cgopipe, "s2": build_s2, "s3": build_s3,
            "s4": build_s4, "deepspeed": build_deepspeed}


def run_schedule(name: str, t: StepTimes, n_layers: int = 8) -> ScheduleResult:
    return simulate(BUILDERS[name](t, n_layers))


def per_layer_latency(name: str, t: StepTimes, n_layers: int = 16) -> float:
    """Steady-state per-layer latency (subtracting pipeline fill)."""
    a = run_schedule(name, t, n_layers)
    b = run_schedule(name, t, n_layers // 2)
    return (a.makespan - b.makespan) / (n_layers - n_layers // 2)
