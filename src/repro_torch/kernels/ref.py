"""Plain PyTorch versions of the port's kernels: the CPU execution path and
the allclose targets the CUDA kernels are held against on the card
(``repro/kernels/ref.py`` and ``ops.flash_prefill``'s reference path)."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, chunked_attention


def moe_ffn_ref(xbuf, wi, wo, wi_scale=None, wo_scale=None, *,
                act: str = "silu"):
    """xbuf: (E,C,D); wi: (E,D,2,F); wo: (E,F,D) -> (E,C,D), computed in
    f32 and cast to xbuf's dtype.  Per-expert scales (E,) dequantize
    weight-only quantized experts."""
    wi = wi.float()
    wo = wo.float()
    if wi_scale is not None:
        wi = wi * wi_scale.float()[:, None, None, None]
    if wo_scale is not None:
        wo = wo * wo_scale.float()[:, None, None]
    h = torch.einsum("ecd,edgf->ecgf", xbuf.float(), wi)
    y = act_fn(act)(h[..., 0, :]) * h[..., 1, :]
    return torch.einsum("ecf,efd->ecd", y, wo).to(xbuf.dtype)


def gqa_decode_ref(q, k, v, valid, *, scale: float, attn_softcap: float = 0.0,
                   k_scale=None, v_scale=None):
    """q: (B,H,D); k: (B,W,Hkv,D); v: (B,W,Hkv,Dv); valid: (B,W) bool.
    Returns (o_unnorm (B,H,Dv) f32, m (B,H) f32, l (B,H) f32) — the
    ``models.attention.attention_partials`` contract.  An int8 ring passes
    k_scale/v_scale (B,W,Hkv) f32, folded into the contractions."""
    from repro_torch.models.attention import attention_partials
    return attention_partials(q, k, v, valid, scale=scale,
                              attn_softcap=attn_softcap, k_scale=k_scale,
                              v_scale=v_scale)


def _merge_fresh(ring, page_table, pos, fresh):
    """The fused form's merge: each row's fresh token (``fresh[name]``,
    one row per batch row, in the arena dtype) written into the gathered
    view at ring position pos % W where that block is mapped, with its
    slot_pos set to pos — what the view holds after the arena scatter."""
    W = ring["slot_pos"].shape[1]
    bt = W // page_table.shape[1]
    i = (pos % W).long()
    hit = torch.gather(page_table, 1, (i // bt)[:, None])[:, 0] >= 0
    b = torch.arange(i.shape[0], device=i.device)
    for name, tok in fresh.items():
        sel = hit.reshape((-1,) + (1,) * (tok.dim() - 1))
        ring[name][b, i] = torch.where(sel, tok, ring[name][b, i])
    ring["slot_pos"][b, i] = torch.where(hit, pos.to(torch.int32),
                                         ring["slot_pos"][b, i])


def paged_gqa_decode_ref(q, layer_cache, pos, *, scale: float,
                         attn_softcap: float = 0.0, window: int = 0,
                         k_new=None, v_new=None, k_scale_new=None,
                         v_scale_new=None):
    """The paged-decode plain version: gather a dense ring view of the
    mapped blocks (``kvcache.paged_view``) and run the partials over it.
    q: (B,H,D); layer_cache: head-major arena ``k``/``v`` (Hkv,NB+1,bt,D),
    ``slot_pos`` (NB+1,bt), ``page_table`` (B,MB); pos: (B,).

    An int8 arena adds ``k_scale``/``v_scale`` (Hkv,NB+1,bt) f32, folded
    into the contractions.

    The fused form passes the fresh token k_new/v_new (B,Hkv,D) in the
    arena dtype (and, for int8, k_scale_new/v_scale_new (B,Hkv) f32): it
    is merged into the gathered view at ring position pos % W where that
    block is mapped — what the view holds after
    ``kvcache.write_decode_paged`` — and the arena is left unwritten."""
    from repro_torch.models import kvcache
    from repro_torch.models.attention import (attention_partials,
                                              decode_valid_mask)
    ring = kvcache.paged_view(layer_cache)
    if k_new is not None:
        fresh = {"k": k_new, "v": v_new}
        if k_scale_new is not None:
            fresh.update(k_scale=k_scale_new, v_scale=v_scale_new)
        _merge_fresh(ring, layer_cache["page_table"], pos, fresh)
    valid = decode_valid_mask(ring["slot_pos"], pos, window)
    return attention_partials(q, ring["k"], ring["v"], valid, scale=scale,
                              attn_softcap=attn_softcap,
                              k_scale=ring.get("k_scale"),
                              v_scale=ring.get("v_scale"))


def paged_mla_decode_ref(qcat, layer_cache, pos, *, scale: float,
                         ckv_new=None, kr_new=None):
    """The absorbed-MLA paged-decode plain version: the dense latent ring
    view of the mapped blocks, key = concat(ckv, kr) as one kv head shared
    by every query head, value = the latent ckv.  qcat: (B,H,lat+dr);
    layer_cache: arena ``ckv`` (NB+1,bt,lat), ``kr`` (NB+1,bt,dr),
    ``slot_pos`` (NB+1,bt), ``page_table`` (B,MB); pos: (B,).  Returns
    partials (o_unnorm (B,H,lat) f32, m, l).

    The fused form passes the fresh latents ckv_new (B,lat) / kr_new
    (B,dr) in the arena dtype, merged as in ``paged_gqa_decode_ref``."""
    from repro_torch.models import kvcache
    from repro_torch.models.attention import (attention_partials,
                                              decode_valid_mask)
    ring = kvcache.paged_view(layer_cache)
    if ckv_new is not None:
        _merge_fresh(ring, layer_cache["page_table"], pos,
                     {"ckv": ckv_new, "kr": kr_new})
    valid = decode_valid_mask(ring["slot_pos"], pos, 0)
    kcat = torch.cat([ring["ckv"], ring["kr"]], -1)[:, :, None, :]
    return attention_partials(qcat, kcat.to(qcat.dtype),
                              ring["ckv"][:, :, None, :], valid, scale=scale)


def flash_prefill_ref(q, k, v, kv_len=None, *, causal: bool = True,
                      window: int = 0, attn_softcap: float = 0.0, scale=None):
    """q: (B,S,H,D); k/v: (B,Skv,Hkv,D/Dv); kv_len: optional (B,).
    Returns (B,S,H,Dv) — ``models.common.chunked_attention``."""
    return chunked_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap, scale=scale,
                             kv_len=kv_len)


def flash_prefill_bwd_ref(q, k, v, o, do, kv_len=None, lse=None, *,
                          causal: bool = True, window: int = 0,
                          attn_softcap: float = 0.0, scale=None):
    """The plain math of the backward kernel (``csrc/flash_prefill_bwd.cu``),
    in f32 over the whole (S, Skv) score matrix, for the tests: raw scores
    x = scale * q.k, s = softcap(x), masked as the forward masks; P =
    exp(s - lse) (lse (B,H,S), each row's log-sum-exp, recomputed here
    when not given); D = rowsum(do * o); dS = P * (dO.V^T - D), times
    1 - (s / cap)^2 under a softcap; dq = scale * dS.K, dk = scale *
    dS^T.Q, dv = P^T.dO, summed over each KV head's query heads.  Returns
    (dq, dk, dv) in f32."""
    B, S, H, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = H // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    x = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    s = (attn_softcap * torch.tanh(x / attn_softcap) if attn_softcap
         else x)
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(Skv, device=dev)[None, :]
    lens = (torch.full((B,), Skv, device=dev) if kv_len is None
            else kv_len.to(dev))
    mask = kp[None] < lens[:, None, None]                   # (B, S, Skv)
    if causal:
        cm = kp <= qp
        if window:
            cm = cm & (kp > qp - window)
        mask = mask & cm[None]
    mask = mask[:, None, None]                              # (B,1,1,S,Skv)
    if lse is None:
        lse = torch.logsumexp(torch.where(mask, s, -torch.inf), -1)
    else:
        lse = lse.float().reshape(B, Hkv, G, S)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float().reshape(B, S, Hkv, G, Dv)
    delta = (dof * o.float().reshape(B, S, Hkv, G, Dv)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if attn_softcap:
        ds = ds * (1 - (s / attn_softcap) ** 2)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.reshape(B, S, H, D), dk, dv


def expert_gather_ref(store, pool, resident_map, layer: int, sel, n_act,
                      manifest):
    """The expert gather's plain version: for each compact slot a, the span
    of expert sel[a] from the pool where the map holds a slot for it, else
    from the host store; zeros for the pad slots (a >= n_act); the leaves
    unflattened (``paging.unflatten_expert_span``) and made contiguous.
    Runs on the device of `sel` (the host rows are copied over)."""
    from repro_torch.core import paging
    dev = sel.device
    idx = sel.long()
    span = store[layer].index_select(0, idx.to(store.device)).to(dev)
    if pool is not None:
        slot = resident_map[layer].to(dev).long()[idx]
        span = torch.where((slot >= 0)[:, None, None],
                           pool[torch.clamp(slot, min=0)], span)
    real = torch.arange(sel.shape[0], device=dev) < n_act.to(dev)
    span = torch.where(real[:, None, None], span, torch.zeros_like(span))
    return _contiguous(paging.unflatten_expert_span(span, manifest))


def expert_miss_plan_ref(resident_map, layer: int, sel, n_act):
    """The misses of one layer's expert gather, in slot order: (a, sel[a])
    for every real slot a < n_act whose expert holds no pool slot
    (``resident_map[layer, sel[a]] < 0``), as an (M, 2) int32 tensor —
    what the gather's plan kernel writes for the copy engine."""
    dev = sel.device
    real = torch.arange(sel.shape[0], device=dev) < n_act.to(dev)
    miss = real & (resident_map[layer].to(dev)[sel.long()] < 0)
    a = torch.nonzero(miss).flatten()
    return torch.stack([a, sel.long()[a]], 1).to(torch.int32)


def _contiguous(tree):
    return {k: (_contiguous(v) if isinstance(v, dict) else v.contiguous())
            for k, v in tree.items()}
