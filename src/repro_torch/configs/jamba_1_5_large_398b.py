"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (+1.5 report).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Mamba:attention 7:1 interleave (one attention layer per 8-layer period, at
position 4 as in the Jamba block), MoE FFN every other layer (odd positions),
dense FFN otherwise.  Jamba uses no positional encoding (the Mamba layers
carry position); attention layers are full-causal.  The long_500k shape runs:
the single KV cache per 8 layers is paged + sequence-sharded.

Deviation, as in the JAX package: the published Jamba uses Mamba-1
(d_state=16); we use our Mamba-2/SSD mixer (d_state=128) as the single SSM
substrate.
"""
from repro_torch.configs.base import (ATTN_FULL, ATTN_NONE, LayerSpec,
                                      ModelConfig)

_M = LayerSpec(kind="mamba", attn=ATTN_NONE, ffn=True)           # mamba + dense FFN
_MM = LayerSpec(kind="mamba", attn=ATTN_NONE, ffn=True, moe=True)  # mamba + MoE FFN
_A = LayerSpec(kind="attn", attn=ATTN_FULL, ffn=True)            # attn + dense FFN

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    dense_d_ff=24_576,
    vocab_size=65_536,
    # period of 8: mamba at 0..3 & 5..7, attention at 4; MoE on odd positions
    period=(_M, _MM, _M, _MM, _A, _MM, _M, _MM),
    num_experts=16,
    top_k=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    ffn_act="silu",
    pos="none",
    tie_embeddings=False,
)
