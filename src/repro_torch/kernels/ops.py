"""Public kernel entry points of the port, dispatched by the tensor's device.

Every dispatcher shares one ``impl`` contract (the JAX package's
``auto | pallas | interpret | ref``, renamed for the card):

  * ``auto`` — the CUDA kernel for a CUDA tensor, its plain PyTorch version
    for a CPU tensor.  A CUDA tensor the kernel does not take raises; nothing
    falls back quietly.
  * ``ref``  — the plain PyTorch version on any device (the reference the
    kernels are held against on the card).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import expert_gather as _eg
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import gqa_decode as _gqa
from repro_torch.kernels import moe_ffn as _moe
from repro_torch.kernels import paged_decode as _paged
from repro_torch.kernels import paged_mla_decode as _mla
from repro_torch.kernels import ref as _ref
from repro_torch.models import kvcache as _kvcache

IMPLS = ("auto", "ref")
KERNELS = {"moe_ffn": _moe.moe_ffn, "gqa_decode": _gqa.gqa_decode,
           "flash_prefill": _fp.flash_prefill,
           "paged_gqa_decode": _paged.paged_gqa_decode,
           "paged_mla_decode": _mla.paged_mla_decode,
           "expert_gather": _eg.expert_gather}


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def moe_ffn(xbuf, wi, wo, wi_scale=None, wo_scale=None, *, act: str = "silu",
            impl: str = "auto"):
    """Grouped gated expert FFN: (E,C,D) -> (E,C,D)."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.moe_ffn_ref(xbuf, wi, wo, wi_scale, wo_scale, act=act)
    return _moe.moe_ffn(xbuf, wi, wo, wi_scale, wo_scale, act=act)


def gqa_decode(q, k, v, valid, *, scale: float, attn_softcap: float = 0.0,
               k_scale=None, v_scale=None, impl: str = "auto"):
    """Flash-decode GQA partials over a dense ring; an int8 ring passes its
    k_scale/v_scale (B,W,Hkv) f32, folded into the tiles."""
    _check_impl(impl)
    kw = dict(scale=scale, attn_softcap=attn_softcap, k_scale=k_scale,
              v_scale=v_scale)
    if impl == "ref":
        return _ref.gqa_decode_ref(q, k, v, valid, **kw)
    return _gqa.gqa_decode(q, k, v, valid, **kw)


def paged_gqa_decode(q, layer_cache, pos, *, scale: float,
                     attn_softcap: float = 0.0, window: int = 0,
                     impl: str = "auto"):
    """Paged flash-decode GQA partials, straight through the page table.
    layer_cache: a paged layer-cache slice — head-major arena ``k``/``v``
    (Hkv, NB+1, bt, D) (+ ``k_scale``/``v_scale`` (Hkv, NB+1, bt) for
    int8), ``slot_pos`` (NB+1, bt), ``page_table`` (B, MB)."""
    _check_impl(impl)
    kw = dict(scale=scale, attn_softcap=attn_softcap, window=window)
    if impl == "ref":
        return _ref.paged_gqa_decode_ref(q, layer_cache, pos, **kw)
    return _paged.paged_gqa_decode(
        q, layer_cache["k"], layer_cache["v"], layer_cache["slot_pos"],
        layer_cache["page_table"], pos, k_scale=layer_cache.get("k_scale"),
        v_scale=layer_cache.get("v_scale"), **kw)


def paged_gqa_decode_fused(q, layer_cache, new, pos, *, scale: float,
                           attn_softcap: float = 0.0, window: int = 0,
                           impl: str = "auto"):
    """Fused decode-write paged GQA: attends over the fresh token and
    scatters it into the arena (in place) in one step.  new: ``k``/``v``
    (B,1,Hkv,D) (+ ``k_scale``/``v_scale`` (B,1,Hkv) f32 for int8, the
    values already int8).  Returns the partials.

    The kernel merges the fresh token, cast to the arena dtype as the
    scatter casts it, into its target block before any score math and
    then the scatter runs on the same stream, so attention over the
    un-written arena equals write-then-attend bit for bit, scales
    included; ``ref`` scatters first and runs the plain version."""
    _check_impl(impl)
    kw = dict(scale=scale, attn_softcap=attn_softcap, window=window)
    if impl == "ref":
        _kvcache._decode_scatter(layer_cache, new, pos)
        return _ref.paged_gqa_decode_ref(q, layer_cache, pos, **kw)
    dt = layer_cache["k"].dtype
    if "k_scale" in layer_cache:
        if new["k"].dtype != torch.int8:
            raise TypeError("an int8 arena takes quantized fresh rows "
                            "(kvcache.quantize_kv)")
        kw.update(k_scale=layer_cache["k_scale"],
                  v_scale=layer_cache["v_scale"],
                  k_scale_new=new["k_scale"][:, 0],
                  v_scale_new=new["v_scale"][:, 0])
    part = _paged.paged_gqa_decode(
        q, layer_cache["k"], layer_cache["v"], layer_cache["slot_pos"],
        layer_cache["page_table"], pos, k_new=new["k"][:, 0].to(dt),
        v_new=new["v"][:, 0].to(dt), **kw)
    _kvcache._decode_scatter(layer_cache, new, pos)
    return part


def paged_mla_decode(qcat, layer_cache, pos, *, scale: float,
                     impl: str = "auto"):
    """Absorbed-MLA paged decode partials over the latent arena, straight
    through the page table.  qcat: (B,H,lat+dr); layer_cache: ``ckv``
    (NB+1,bt,lat), ``kr`` (NB+1,bt,dr), ``slot_pos`` (NB+1,bt),
    ``page_table`` (B,MB).  The attended value is the latent itself."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.paged_mla_decode_ref(qcat, layer_cache, pos, scale=scale)
    return _mla.paged_mla_decode(
        qcat, layer_cache["ckv"], layer_cache["kr"], layer_cache["slot_pos"],
        layer_cache["page_table"], pos, scale=scale)


def paged_mla_decode_fused(qcat, layer_cache, new, pos, *, scale: float,
                           impl: str = "auto"):
    """Fused decode-write paged MLA (see ``paged_gqa_decode_fused``).
    new: ``ckv`` (B,1,lat) / ``kr`` (B,1,dr).  Returns the partials."""
    _check_impl(impl)
    if impl == "ref":
        _kvcache._decode_scatter(layer_cache, new, pos)
        return _ref.paged_mla_decode_ref(qcat, layer_cache, pos, scale=scale)
    dt = layer_cache["ckv"].dtype
    part = _mla.paged_mla_decode(
        qcat, layer_cache["ckv"], layer_cache["kr"], layer_cache["slot_pos"],
        layer_cache["page_table"], pos, scale=scale,
        ckv_new=new["ckv"][:, 0].to(dt).contiguous(),
        kr_new=new["kr"][:, 0].to(dt).contiguous())
    _kvcache._decode_scatter(layer_cache, new, pos)
    return part


def flash_prefill(q, k, v, kv_len=None, *, causal: bool = True,
                  window: int = 0, attn_softcap: float = 0.0, scale=None,
                  impl: str = "auto"):
    """Prefill flash attention, normalized output."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.flash_prefill_ref(q, k, v, kv_len, causal=causal,
                                      window=window,
                                      attn_softcap=attn_softcap, scale=scale)
    return _fp.flash_prefill(q, k, v, kv_len, causal=causal, window=window,
                             attn_softcap=attn_softcap, scale=scale)


def expert_gather(store, pool, resident_map, layer: int, sel, n_act,
                  manifest, *, impl: str = "auto"):
    """The activated experts' spans of one layer as contiguous (A, ...)
    leaves: resident ones from the device pool, the rest from the pinned
    host store, zeros for pad slots (``kernels/expert_gather.py``)."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.expert_gather_ref(store, pool, resident_map, layer, sel,
                                      n_act, manifest)
    return _eg.expert_gather(store, pool, resident_map, layer, sel, n_act,
                             manifest)


def expert_miss_plan(resident_map, layer: int, sel, n_act):
    """The gather's misses, (a, sel[a]) pairs (M, 2) int32 in slot order:
    the plain version of the plan the kernel writes on the device (it
    reads the count back, so it is for checks, not the served path)."""
    return _ref.expert_miss_plan_ref(resident_map, layer, sel, n_act)
