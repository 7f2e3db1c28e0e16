"""Mixture-of-Experts FFN of the PyTorch port (``repro/models/moe.py``).

Execution paths (numerically equivalent up to capacity drops):

  * ``moe_dense``   — masked loop over experts; the oracle for tests.
  * ``moe_grouped`` — capacity-bucketed grouped FFN: scatter tokens to
    (E, C, D) buckets, run the grouped expert FFN (the ``moe_ffn`` kernel
    with ``use_kernel``), gather back.  With ``token_groups`` (module-based
    batching) the buckets hold G rotation groups' tokens in disjoint
    per-group spans, so C = G·cap and one launch serves the window.

  * ``moe_paged``   — the expert-granular paged path's two-phase step:
    the router first, then only the activated experts' spans are fetched
    (``fetch_experts``: resident ones from the device pool, misses from the
    pinned host store) and computed on as a compacted subset.

  * ``moe_ep_psum_local`` / ``moe_ep_a2a_local`` — the expert-parallel
    bodies a sharding plan runs on every rank of its mesh (tokens
    replicated and the output summed, or tokens exchanged by all-to-all),
    each through ``grouped_ffn``.

Gate/up projections are stored as (D, 2, F), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import act_fn, by_group


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def route(cfg: ModelConfig, router_w, x, token_groups: Optional[int] = None,
          aux_group=None):
    """x: (T, D) -> (weights (T,k) f32, idx (T,k) int64, aux_loss scalar).
    token_groups: a window's tokens, scored group by group.

    aux_group: the process group over whose ranks the batch's tokens are
    split (a step under a plan).  The load-balance loss is then the global
    batch's: the tokens routed to each expert (f_e) and the softmax mass
    (P_e) summed over the group before their product, P_e's sum with an
    identity backward, so each rank's gradient is its own tokens' share."""
    scores = by_group(lambda x: torch.matmul(x.float(), router_w.float()),
                      token_groups, x)
    if cfg.router_scale:                       # deepseek: sigmoid + renorm
        probs = torch.sigmoid(scores)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(scores, dim=-1)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    # Switch-style load-balance loss over softmax probabilities
    sm = torch.softmax(scores, dim=-1)
    T = x.shape[0]
    if aux_group is not None:
        from repro_torch.distributed import collectives as C
        counts = torch.zeros((cfg.num_experts + 1,), dtype=torch.float32,
                             device=x.device)
        counts.index_add_(0, idx.reshape(-1),
                          torch.ones((idx.numel(),), device=x.device))
        counts[-1] = T
        counts = C.all_reduce(counts, aux_group)
        n = counts[-1]
        mass = C.reduce_from(sm.sum(0), aux_group) / n
        aux = cfg.num_experts * torch.sum(counts[:-1] / (n * cfg.top_k)
                                          * mass)
        return w, idx, aux
    frac = torch.zeros((cfg.num_experts,), dtype=torch.float32,
                       device=x.device)
    frac.index_add_(0, idx.reshape(-1),
                    torch.full((idx.numel(),), 1.0 / (T * cfg.top_k),
                               device=x.device))
    aux = cfg.num_experts * torch.sum(frac * sm.mean(0))
    return w, idx, aux


def expert_weights(p: Dict, dtype):
    """Dequantize int8 experts (weight-only quant, per-expert scale) to the
    compute dtype; pass-through otherwise."""
    wi, wo = p["wi"], p["wo"]
    if "wi_scale" in p:
        wi = wi.to(dtype) * p["wi_scale"].to(dtype)[:, None, None, None]
        wo = wo.to(dtype) * p["wo_scale"].to(dtype)[:, None, None]
    return wi, wo


def gated_ffn(cfg: ModelConfig, wi, wo, x):
    """x: (..., D); wi: (D, 2, F); wo: (F, D)."""
    h = torch.einsum("...d,dgf->...gf", x, wi.to(x.dtype))
    y = act_fn(cfg.ffn_act)(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("...f,fd->...d", y, wo.to(x.dtype))


def _shared(cfg: ModelConfig, p: Dict, x, token_groups=None):
    """The shared experts' FFN (a window's tokens group by group)."""
    return by_group(lambda x: gated_ffn(cfg, p["shared"]["wi"],
                                        p["shared"]["wo"], x),
                    token_groups, x)


# ---------------------------------------------------------------------------
# Capacity bucketing
# ---------------------------------------------------------------------------

def _bucket(dest, n_buckets: int, cap: int):
    """dest: (N,) in [0, n_buckets) or -1. Returns (slot (N,), keep (N,)):
    rank of each entry within its bucket; keep = slot < cap and dest >= 0."""
    onehot = dest[:, None] == torch.arange(n_buckets, device=dest.device)
    rank = torch.cumsum(onehot.long(), dim=0) - 1                # (N, nb)
    slot = torch.where(onehot, rank, 0).sum(1)
    keep = (dest >= 0) & (slot < cap)
    return slot, keep


def stage_bucket(dest, n_buckets: int, cap: int, groups: int = 1):
    """Staging map of module-based batching: ranking per (group, bucket)
    with per-group capacity ``cap``, staged slot ``g·cap + rank``.  dest is
    laid out group-major.  groups=1 is ``_bucket`` exactly."""
    N = dest.shape[0]
    if N % groups:
        raise ValueError("flat entries must split evenly over groups")
    g = torch.arange(N, device=dest.device) // (N // groups)
    gb = torch.where(dest >= 0, g * n_buckets + dest, -1)
    rank, keep = _bucket(gb, groups * n_buckets, cap)
    return g * cap + rank, keep


def grouped_ffn(cfg: ModelConfig, wi, wo, xbuf, use_kernel: bool = False,
                wi_scale=None, wo_scale=None, impl: str = "auto"):
    """xbuf: (E, C, D); wi: (E, D, 2, F); wo: (E, F, D) -> (E, C, D).
    use_kernel: the grouped expert FFN kernel (``ops.moe_ffn``, f32
    accumulation); otherwise plain einsums in xbuf's dtype, as the JAX
    path."""
    if use_kernel:
        return ops.moe_ffn(xbuf, wi, wo, wi_scale, wo_scale,
                           act=cfg.ffn_act, impl=impl)
    if wi_scale is not None:
        wi = wi.to(xbuf.dtype) * wi_scale[:, None, None, None].to(xbuf.dtype)
        wo = wo.to(xbuf.dtype) * wo_scale[:, None, None].to(xbuf.dtype)
    h = torch.einsum("ecd,edgf->ecgf", xbuf, wi.to(xbuf.dtype))
    y = act_fn(cfg.ffn_act)(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("ecf,efd->ecd", y, wo.to(xbuf.dtype))


# ---------------------------------------------------------------------------
# Dense (oracle) path
# ---------------------------------------------------------------------------

def moe_dense(cfg: ModelConfig, p: Dict, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D). Returns (out (T,D), aux_loss)."""
    w, idx, aux = route(cfg, p["router"], x)
    wi_all, wo_all = expert_weights(p, x.dtype)
    out = torch.zeros_like(x, dtype=torch.float32)
    for e in range(cfg.num_experts):
        y = gated_ffn(cfg, wi_all[e], wo_all[e], x)
        we = torch.where(idx == e, w, 0.0).sum(-1)                # (T,)
        out = out + y.float() * we[:, None]
    out = out.to(x.dtype)
    if cfg.num_shared_experts:
        out = out + gated_ffn(cfg, p["shared"]["wi"], p["shared"]["wo"], x)
    return out, aux


# ---------------------------------------------------------------------------
# Grouped path
# ---------------------------------------------------------------------------

def combine_routed(x, y, K: int):
    """Each token's K weighted expert outputs summed: y (T*K, D) in (token,
    k) order -> (T, D), added k by k, each partial sum rounded to x's
    dtype: the reference's ``.at[flat_t].add`` gives these bits in bf16
    too, where ``index_add_`` on the CPU and a ``sum`` over k (which
    accumulate in f32 and round once) do not.  ``index_add_`` on the card
    adds through atomics in any order, so past K = 2 its bits would change
    from call to call (moonshot's top-6, DeepSeek-V3's top-8).  K - 1
    adds."""
    y = y.reshape(x.shape[0], K, -1)
    out = y[:, 0]
    for k in range(1, K):
        out = out + y[:, k]
    return out


def moe_grouped(cfg: ModelConfig, p: Dict, x, *, capacity_factor=None,
                use_kernel: bool = False, impl: str = "auto",
                token_groups: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D).  Every shape depends on T alone (the capacity too), and
    nothing is read back to the host, so a decode step keeps fixed shapes.

    token_groups: module-based batching — x concatenates that many
    rotation groups' tokens (group-major).  Capacity and keep/drop are
    then decided per group (``stage_bucket``), so every group's output
    equals running it alone, while the expert FFN runs once over the
    whole staged buffer."""
    T, D = x.shape
    NE, K = cfg.num_experts, cfg.top_k
    G = token_groups or 1
    cf = capacity_factor or cfg.capacity_factor
    cap = max(1, int((T // G) * K * cf / NE + 0.999))

    w, idx, aux = route(cfg, p["router"], x, token_groups)
    flat_e = idx.reshape(-1)                                     # (T*K,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_w = w.reshape(-1)
    slot, keep = stage_bucket(flat_e, NE, cap, G)
    e_safe = torch.where(keep, flat_e, 0)
    s_safe = torch.where(keep, slot, G * cap - 1)

    xbuf = torch.zeros((NE, G * cap, D), dtype=x.dtype, device=x.device)
    xbuf.index_put_((e_safe, s_safe),
                    torch.where(keep[:, None], x[flat_t], 0).to(x.dtype),
                    accumulate=True)
    ybuf = grouped_ffn(cfg, p["wi"], p["wo"], xbuf, use_kernel,
                       p.get("wi_scale"), p.get("wo_scale"), impl=impl)
    y = ybuf[e_safe, s_safe]                                     # (T*K, D)
    y = torch.where(keep[:, None], y, 0) * flat_w[:, None].to(x.dtype)
    out = combine_routed(x, y, K)
    if cfg.num_shared_experts:
        out = out + _shared(cfg, p, x, token_groups)
    return out, aux


# ---------------------------------------------------------------------------
# Expert-parallel bodies (run on every rank of a mesh by the plan's moe_fn,
# distributed.collectives.make_moe_shard_fn)
# ---------------------------------------------------------------------------

def _expert_slice(mesh, expert_axes) -> Tuple[int, int]:
    """(shards, this rank's index) over the expert axes, which must be in
    mesh order: the experts' blocks and the all-to-all's lanes both follow
    a group's rank order."""
    if mesh.in_mesh_order(expert_axes) != tuple(expert_axes):
        raise ValueError(f"expert axes {expert_axes} are not in mesh order")
    return mesh.axis_size(expert_axes), mesh.axis_index(expert_axes)


def _local_experts(cfg: ModelConfig, p: Dict, x, w, idx, e0: int, cap: int,
                   use_kernel: bool, impl: str):
    """Every token's weighted outputs of the experts e0 .. e0 + E_loc - 1
    that ``p`` holds (E_loc of them), each expert's bucket ranked over the
    tokens in order and cut at ``cap`` (the buckets ``moe_grouped`` fills
    for those experts).  x (T, D), w / idx (T, K) -> (T, D)."""
    T, D = x.shape
    K = cfg.top_k
    E_loc = p["wi"].shape[0]
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    local_e = idx.reshape(-1) - e0
    dest = torch.where((local_e >= 0) & (local_e < E_loc), local_e, -1)
    slot, keep = _bucket(dest, E_loc, cap)
    e_safe = torch.where(keep, dest, 0)
    s_safe = torch.where(keep, slot, cap - 1)
    xbuf = torch.zeros((E_loc, cap, D), dtype=x.dtype, device=x.device)
    xbuf = xbuf.index_put((e_safe, s_safe),
                          torch.where(keep[:, None], x[flat_t], 0),
                          accumulate=True)
    ybuf = grouped_ffn(cfg, p["wi"], p["wo"], xbuf, use_kernel,
                       p.get("wi_scale"), p.get("wo_scale"), impl=impl)
    y = torch.where(keep[:, None], ybuf[e_safe, s_safe], 0)
    return combine_routed(x, y * w.reshape(-1, 1).to(x.dtype), K)


def moe_ep_psum_local(cfg: ModelConfig, p_local: Dict, x, *, mesh,
                      expert_axes, capacity_factor=None,
                      use_kernel: bool = False, ffn_axes=(),
                      impl: str = "auto", aux_group=None):
    """Tokens replicated over expert_axes (+ffn_axes); p_local holds this
    rank's expert slice wi (E_loc, D, 2, F_loc), wo (E_loc, F_loc, D) and
    the whole router.  With ffn_axes set, each expert's FFN dim is also
    sharded (2D stationary weights) and the output sum covers both axis
    groups: decode moves only (T, D)-sized activations while every weight
    stays on its shard.  The shared experts, replicated over the expert
    axes, enter the sum divided by their count.  x: (T, D).  aux_group:
    as ``route``'s."""
    from repro_torch.distributed.collectives import reduce_from
    T = x.shape[0]
    NE, K = cfg.num_experts, cfg.top_k
    M, my = _expert_slice(mesh, expert_axes)
    E_loc = NE // M
    cf = capacity_factor or cfg.capacity_factor
    cap_e = max(1, int(T * K * cf / NE + 0.999))

    w, idx, aux = route(cfg, p_local["router"], x, aux_group=aux_group)
    out = _local_experts(cfg, p_local, x, w, idx, my * E_loc, cap_e,
                         use_kernel, impl)
    if cfg.num_shared_experts:
        out = out + gated_ffn(cfg, p_local["shared"]["wi"],
                              p_local["shared"]["wo"], x) / M
    reduce_axes = tuple(expert_axes) + tuple(ffn_axes)
    return reduce_from(out, mesh.group(reduce_axes)), aux


def moe_ep_a2a_local(cfg: ModelConfig, p_local: Dict, x, *, mesh,
                     expert_axes, capacity_factor=None,
                     use_kernel: bool = False, impl: str = "auto",
                     aux_group=None):
    """Tokens sharded over expert_axes (x is this rank's token slice):
    routed tokens go to their expert's rank and back by all-to-all, in
    lanes of ``cap`` tokens per (source, destination) pair.  aux is the
    mean of the ranks' router losses, or with ``aux_group`` (as
    ``route``'s) the global batch's.  x: (T_loc, D)."""
    from repro_torch.distributed.collectives import all_to_all, reduce_from
    T, D = x.shape
    NE, K = cfg.num_experts, cfg.top_k
    M, _ = _expert_slice(mesh, expert_axes)
    group = mesh.group(expert_axes)
    E_loc = NE // M
    cf = capacity_factor or cfg.capacity_factor
    cap = max(1, int(T * K * cf / M + 0.999))            # per src->dst lane
    cap_e = max(1, int(M * cap * cf / E_loc + 0.999))    # per local expert

    w, idx, aux = route(cfg, p_local["router"], x, aux_group=aux_group)
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_w = w.reshape(-1)
    dest = flat_e // E_loc
    slot, keep = _bucket(dest, M, cap)
    d_safe = torch.where(keep, dest, 0)
    s_safe = torch.where(keep, slot, cap - 1)

    send_x = torch.zeros((M, cap, D), dtype=x.dtype, device=x.device)
    send_x = send_x.index_put((d_safe, s_safe),
                              torch.where(keep[:, None], x[flat_t], 0),
                              accumulate=True)
    send_le = torch.full((M * cap,), -1, dtype=torch.int32, device=x.device)
    send_le.scatter_reduce_(0, d_safe * cap + s_safe,
                            torch.where(keep, flat_e % E_loc, -1).to(
                                torch.int32), reduce="amax")
    rx = all_to_all(send_x, group).reshape(M * cap, D)
    rle = all_to_all(send_le, group).long()

    slot2, keep2 = _bucket(rle, E_loc, cap_e)
    e2 = torch.where(keep2, rle, 0)
    s2 = torch.where(keep2, slot2, cap_e - 1)
    xbuf = torch.zeros((E_loc, cap_e, D), dtype=x.dtype, device=x.device)
    xbuf = xbuf.index_put((e2, s2), torch.where(keep2[:, None], rx, 0),
                          accumulate=True)
    ybuf = grouped_ffn(cfg, p_local["wi"], p_local["wo"], xbuf, use_kernel,
                       p_local.get("wi_scale"), p_local.get("wo_scale"),
                       impl=impl)
    ry = torch.where(keep2[:, None], ybuf[e2, s2], 0).reshape(M, cap, D)
    back = all_to_all(ry, group)
    y = torch.where(keep[:, None], back[d_safe, s_safe], 0)
    out = combine_routed(x, y * flat_w[:, None].to(x.dtype), K)
    if cfg.num_shared_experts:
        out = out + gated_ffn(cfg, p_local["shared"]["wi"],
                              p_local["shared"]["wo"], x)
    if aux_group is None:
        aux = reduce_from(aux, group) / M
    return out, aux


# ---------------------------------------------------------------------------
# Expert-granular paged path (two-phase layer step)
# ---------------------------------------------------------------------------

def activated_experts(idx, num_experts: int, max_active: int):
    """Compact the routed expert set: idx (T, K) -> (sel, index_map, n_act).

    sel (max_active,) int32: activated expert ids in ascending order,
    padded with 0 beyond n_act.  index_map (E,) int32: expert id -> compact
    slot, -1 if not activated.  n_act: () int32.  ``max_active`` must be
    >= min(E, T*K).  Everything stays on the device: sel is a scatter of
    the expert ids into their compact slots (the inactive ones into a
    dropped slot max_active), not a ``nonzero``, which would wait for the
    host."""
    dev = idx.device
    hit = torch.zeros((num_experts,), dtype=torch.bool, device=dev)
    hit[idx.reshape(-1)] = True
    index_map = torch.where(hit, torch.cumsum(hit, 0) - 1, -1).to(torch.int32)
    dest = torch.where(hit, index_map, max_active).long()
    sel = torch.zeros((max_active + 1,), dtype=torch.int32, device=dev)
    sel.scatter_(0, dest, torch.arange(num_experts, dtype=torch.int32,
                                       device=dev))
    return sel[:max_active], index_map, hit.sum().to(torch.int32)


def _dense_subset(cfg: ModelConfig, ep: Dict, x, w, idx, sel, n_act):
    """Dense-oracle compute on a compacted expert subset, accumulated in
    ascending activated-expert order (``moe_dense`` up to ±0: the experts
    it skips contribute exactly zero there).  Pad slots are weighted by
    exactly zero, so their weights must be finite (the gather zeros them)."""
    A = ep["wi"].shape[0]
    wi_all, wo_all = expert_weights(ep, x.dtype)
    out = torch.zeros_like(x, dtype=torch.float32)
    for a in range(A):
        y = gated_ffn(cfg, wi_all[a], wo_all[a], x)
        we = torch.where(idx == sel[a], w, 0.0).sum(-1)             # (T,)
        we = torch.where(a < n_act, we, 0.0)    # mask pad slots (sel[a] == 0)
        out = out + y.float() * we[:, None]
    return out.to(x.dtype)


def _grouped_subset(cfg: ModelConfig, ep: Dict, x, w, idx, index_map,
                    capacity_factor=None, use_kernel: bool = False,
                    impl: str = "auto", token_groups: Optional[int] = None):
    """Capacity-bucketed grouped compute on a compacted subset.  Capacity
    and keep/drop decisions use the FULL expert count, so drops are those
    of ``moe_grouped`` on the full set.  token_groups: as in
    ``moe_grouped`` — a disjoint ``cap``-wide span per (group, expert),
    one grouped FFN per activated expert over the whole window."""
    T, D = x.shape
    NE, K = cfg.num_experts, cfg.top_k
    A = ep["wi"].shape[0]
    G = token_groups or 1
    cf = capacity_factor or cfg.capacity_factor
    cap = max(1, int((T // G) * K * cf / NE + 0.999))

    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_w = w.reshape(-1)
    dest = index_map[flat_e].long()            # compact slot, always >= 0
    slot, keep = stage_bucket(dest, A, cap, G)
    e_safe = torch.where(keep, dest, 0)
    s_safe = torch.where(keep, slot, G * cap - 1)

    xbuf = torch.zeros((A, G * cap, D), dtype=x.dtype, device=x.device)
    xbuf.index_put_((e_safe, s_safe),
                    torch.where(keep[:, None], x[flat_t], 0).to(x.dtype),
                    accumulate=True)
    ybuf = grouped_ffn(cfg, ep["wi"], ep["wo"], xbuf, use_kernel,
                       ep.get("wi_scale"), ep.get("wo_scale"), impl=impl)
    y = ybuf[e_safe, s_safe]
    y = torch.where(keep[:, None], y, 0) * flat_w[:, None].to(x.dtype)
    return combine_routed(x, y, K)


def moe_paged(cfg: ModelConfig, p: Dict, x, *, fetch_experts, policy=None,
              max_active: Optional[int] = None,
              token_groups: Optional[int] = None):
    """Two-phase MoE step for expert-granular paged weights: run the router
    FIRST, then fetch only the activated experts' spans
    (``fetch_experts(sel (A,), n_act) -> {wi (A,...), wo (A,...)}``) and
    compute on the compacted subset.

    x: (T, D).  Returns (out, aux_loss, counts (E,) int32 — tokens routed
    to each expert, the residency EWMA's observation).  Numerics match
    moe_dense / moe_grouped on the full expert set, so greedy transcripts
    equal the resident path's.  Nothing is read back to the host.

    token_groups=G (module-based batching): x concatenates G rotation
    groups' tokens group-major.  The activated set (and the span fetch)
    covers the union of the groups' routed experts, so each fetched span
    serves every group's staged tokens in one window, while each group's
    numbers equal a call of its own; counts is then (G, E)."""
    T, D = x.shape
    NE, K = cfg.num_experts, cfg.top_k
    A = max_active if max_active is not None else min(NE, T * K)
    w, idx, aux = route(cfg, p["router"], x, token_groups)
    flat_e = idx.reshape(-1)
    ones = torch.ones_like(flat_e, dtype=torch.int32)
    if token_groups:
        G = token_groups
        g_flat = torch.arange(T * K, device=x.device) // (K * (T // G))
        counts = torch.zeros((G * NE,), dtype=torch.int32, device=x.device)
        counts.index_add_(0, g_flat * NE + flat_e, ones)
        counts = counts.reshape(G, NE)
    else:
        counts = torch.zeros((NE,), dtype=torch.int32, device=x.device)
        counts.index_add_(0, flat_e, ones)
    sel, index_map, n_act = activated_experts(idx, NE, A)
    ep = fetch_experts(sel, n_act)
    if "wi_scale" in p:
        # int8 dequant scales live in the shared span: gather the activated
        # experts' scales
        ep = dict(ep, wi_scale=p["wi_scale"][sel.long()],
                  wo_scale=p["wo_scale"][sel.long()])
    if policy is not None and policy.moe_impl == "grouped":
        out = _grouped_subset(cfg, ep, x, w, idx, index_map,
                              use_kernel=policy.use_kernels,
                              impl=policy.impl, token_groups=token_groups)
    else:
        out = _dense_subset(cfg, ep, x, w, idx, sel, n_act)
    if cfg.num_shared_experts:
        out = out + _shared(cfg, p, x, token_groups)
    return out, aux, counts


def moe_apply_paged(cfg: ModelConfig, p: Dict, x3, fetch_experts,
                    policy=None, token_groups: Optional[int] = None):
    """(B, S, D) wrapper around moe_paged (the expert-granular analogue of
    moe_apply).  With token_groups, B is G·ubatch (decode windows), so the
    flat group-major layout holds."""
    B, S, D = x3.shape
    out, aux, counts = moe_paged(cfg, p, x3.reshape(B * S, D),
                                 fetch_experts=fetch_experts, policy=policy,
                                 token_groups=token_groups)
    return out.reshape(B, S, D), aux, counts


def moe_grouped_tp(cfg: ModelConfig, p: Dict, x3, policy):
    """The grouped MoE of a plan over more than one rank (the plan's
    ``grouped_pjit``): x3 (B, S, D) this rank's rows over the dp axes, the
    same on every other rank; p this rank's slice of one layer's MoE
    leaves: its experts (over the plan's expert axes) or every expert on
    its slice of ``effn``.

    Routing runs on this rank's rows.  The rows, their weights and choices
    are gathered over the dp axes in their global order, so each expert's
    capacity bucket holds the tokens it holds on one device; this rank's
    experts (or expert slices) run on them, their outputs are summed over
    the axes that split the experts and cut back to this rank's rows.  The
    gradient follows the conjugate pairs (``distributed.collectives``);
    aux is the global batch's (``route``'s ``aux_group``)."""
    from repro_torch.distributed import collectives as C
    sh = policy.shard
    mesh = sh.mesh
    B, S, D = x3.shape
    NE, K = cfg.num_experts, cfg.top_k
    dp, e_ax = tuple(sh.dp_axes), tuple(sh.expert_axes)
    if set(dp) & set(e_ax) not in (set(), set(dp)):
        raise NotImplementedError(f"experts over {e_ax} with the batch over "
                                  f"{dp}: their overlap is not ported")
    f_ax = sh.axes_of("effn") if p["wi"].shape[-1] != cfg.d_ff else ()
    red = sh.group(tuple(a for a in e_ax if a not in dp) + f_ax)
    g_dp = sh.group(dp)
    x = x3.reshape(-1, D)
    T_loc = x.shape[0]
    w, idx, aux = route(cfg, p["router"], x, aux_group=g_dp)
    if g_dp is not None:
        x, w = C.fsdp_gather(x, g_dp, 0), C.fsdp_gather(w, g_dp, 0)
        idx = C.gather_from(idx, g_dp, 0)
    x, w = C.copy_to(x, red), C.copy_to(w, red)
    E_loc = p["wi"].shape[0]
    e0 = mesh.axis_index(e_ax) * E_loc if E_loc != NE else 0
    cap = max(1, int(x.shape[0] * K * cfg.capacity_factor / NE + 0.999))
    out = C.reduce_from(_local_experts(cfg, p, x, w, idx, e0, cap,
                                       policy.use_kernels, policy.impl), red)
    if g_dp is not None:
        if e_ax and set(dp) <= set(e_ax):
            out = C.reduce_scatter(out, g_dp, 0)
        else:       # every dp rank computed every row
            out = out.narrow(0, mesh.axis_index(dp) * T_loc, T_loc)
    return out.reshape(B, S, D), aux


def moe_apply(cfg: ModelConfig, p: Dict, x3, policy=None,
              token_groups: Optional[int] = None):
    """Dispatch on the execution policy. x3: (B, S, D)."""
    if policy is not None and policy.moe_fn is not None:
        return policy.moe_fn(cfg, p, x3, impl=policy.impl)
    if policy is not None and policy.shard is not None:
        return moe_grouped_tp(cfg, p, x3, policy)
    B, S, D = x3.shape
    x = x3.reshape(B * S, D)
    if policy is not None and policy.moe_impl == "grouped":
        out, aux = moe_grouped(cfg, p, x, use_kernel=policy.use_kernels,
                               impl=policy.impl, token_groups=token_groups)
    else:
        out, aux = moe_dense(cfg, p, x)
    return out.reshape(B, S, D), aux
