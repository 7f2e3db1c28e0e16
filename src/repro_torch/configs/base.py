"""Config system of the PyTorch port: model architecture configs + workload
shape registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing of
that package), with ``param_count`` pointed at the port's own
``repro_torch.models.params.count_params``.  Configs are plain frozen
dataclasses, so they are hashable and trivially serializable.

Layer structure is described by a *period*: a tuple of `LayerSpec`s that
repeats down the stack (plus optional non-repeating prologue layers); the
parameters of each period position are stacked on a leading layer axis.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

ATTN_FULL = "full"          # full causal attention
ATTN_WINDOW = "window"      # sliding-window causal attention
ATTN_MLA = "mla"            # DeepSeek multi-head latent attention
ATTN_NONE = "none"          # attention-free (pure-FFN or mamba layer)


@dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating period."""
    kind: str = "attn"                  # "attn" | "mamba"
    attn: str = ATTN_FULL               # attention flavor (if kind == "attn")
    window: int = 0                     # sliding window size (attn == "window")
    moe: bool = False                   # MoE FFN instead of dense FFN
    ffn: bool = True                    # has an FFN at all (mamba layers: False)
    cross_attn: bool = False            # encoder-decoder cross attention (whisper)

    def cache_kind(self) -> str:
        if self.kind == "mamba":
            return "ssm"
        if self.attn == ATTN_MLA:
            return "mla"
        if self.attn == ATTN_NONE:
            return "none"
        return "kv"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Field names follow the paper's Table 1 where
    applicable (h1 = d_model, h2 = d_ff, n_q/n_kv heads, n_e/k experts)."""

    name: str
    family: str                          # dense | moe | ssm | hybrid | vlm | audio

    # Core dims
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                    # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # Layer-structure period (repeats); prologue precedes the periodic part.
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prologue: Tuple[LayerSpec, ...] = ()

    # Attention details
    pos: str = "rope"                    # rope | learned | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    logit_softcap: float = 0.0           # gemma2 final-logit softcap
    attn_softcap: float = 0.0            # gemma2 attention-logit softcap
    window_size: int = 4096              # sliding window width for ATTN_WINDOW
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # Norm / embedding details
    norm: str = "rmsnorm"                # rmsnorm | layernorm | nonparametric_ln
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    scale_embeddings: bool = False       # gemma: multiply embed by sqrt(d_model)
    post_block_norm: bool = False        # gemma2: extra norms after attn/ffn

    # FFN
    ffn_act: str = "silu"                # silu (swiglu) | gelu (geglu) | gelu_mlp
    dense_d_ff: int = 0                  # d_ff for non-MoE layers when mixed (dsv3)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0          # deepseek shared expert(s)
    router_scale: bool = False           # deepseek sigmoid-routing normalization
    capacity_factor: float = 1.25        # train-time expert capacity

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                 # fixed encoder positions (1500 frames)

    # VLM prefix (paligemma)
    vision_tokens: int = 0               # number of stubbed patch-embedding tokens

    # Numerics
    dtype: str = "bfloat16"
    expert_dtype: str = ""        # "" (= dtype) | "int8" weight-only quant
    kv_dtype: str = ""            # "" (= dtype) | "int8" KV-cache quant
                                  # (per-token-per-head scales; paper §3.3
                                  # discusses int4 KV for the same reason)

    # ---------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # Derived -------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return all(s.kind == "mamba" for s in self.period + self.prologue)

    @property
    def has_subquadratic_path(self) -> bool:
        """True if *every* attention in the stack is windowed or absent —
        the criterion for running the long_500k shape."""
        specs = self.period + self.prologue
        return all(s.kind == "mamba" or s.attn in (ATTN_NONE, ATTN_WINDOW)
                   for s in specs)

    @property
    def layers_per_period(self) -> int:
        return len(self.period)

    @property
    def num_periods(self) -> int:
        n = self.num_layers - len(self.prologue)
        assert n % len(self.period) == 0, (
            f"{self.name}: {self.num_layers} layers minus {len(self.prologue)} "
            f"prologue not divisible by period {len(self.period)}")
        return n // len(self.period)

    # Parameter accounting (used by HRM and the roofline report) -----
    def param_count(self) -> int:
        from repro_torch.models.params import count_params  # avoid cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params
        return count_params(self, active_only=True)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        n_period = len(self.period)
        n_pro = len(self.prologue)
        kw = dict(
            name=self.name + "-smoke",
            num_layers=n_pro + 2 * n_period,
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else 0,
            head_dim=16,
        )
        if self.num_heads:
            kw["num_heads"] = 4
            kw["num_kv_heads"] = max(1, min(self.num_kv_heads, 2))
        if self.is_moe:
            kw["num_experts"] = min(self.num_experts, 8)
            kw["top_k"] = min(self.top_k, 2)
        if self.q_lora_rank or self.kv_lora_rank:
            kw.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=32)
        if self.vision_tokens:
            kw.update(vision_tokens=16)
        if self.window_size:
            kw["window_size"] = min(self.window_size, 32)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                # "train" | "prefill" | "decode"

    def smoke(self) -> "ShapeConfig":
        return ShapeConfig(self.name + "-smoke", min(self.seq_len, 64),
                           min(self.global_batch, 4), self.mode)


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Task-spec applicability matrix. Returns (runnable, reason-if-not).

    long_500k runs for SSM / hybrid stacks (per task spec): a hybrid's few
    attention layers keep a paged, sequence-sharded KV cache; pure
    full-attention stacks skip."""
    if shape.name.startswith("long_"):
        ok = cfg.family in ("ssm", "hybrid") or cfg.has_subquadratic_path
        if not ok:
            return False, ("skip(full-attn): long_500k requires "
                           "sub-quadratic attention")
    return True, ""
