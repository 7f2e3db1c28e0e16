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

from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import gqa_decode as _gqa
from repro_torch.kernels import moe_ffn as _moe
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "ref")
KERNELS = {"moe_ffn": _moe.moe_ffn, "gqa_decode": _gqa.gqa_decode,
           "flash_prefill": _fp.flash_prefill}


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
               impl: str = "auto"):
    """Flash-decode GQA partials over a dense ring."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.gqa_decode_ref(q, k, v, valid, scale=scale,
                                   attn_softcap=attn_softcap)
    return _gqa.gqa_decode(q, k, v, valid, scale=scale,
                           attn_softcap=attn_softcap)


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
