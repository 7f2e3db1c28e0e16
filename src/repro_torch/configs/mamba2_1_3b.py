"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048, attention-free, vocab=50280, ssm_state=128.
expand=2 -> d_inner=4096, ssm_head_dim=64 -> 64 SSD heads, conv width 4,
chunked SSD with chunk=256.  No FFN (the mamba mixer is the whole block).
"""
from repro_torch.configs.base import ATTN_NONE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    period=(LayerSpec(kind="mamba", attn=ATTN_NONE, ffn=False),),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    pos="none",
    tie_embeddings=True,
)
