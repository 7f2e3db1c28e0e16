"""glm4-9b [dense] — hf:THUDM/glm-4-9b.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE, GQA, QKV bias, SwiGLU, RMSNorm, untied head.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13_696,
    vocab_size=151_552,
    period=(LayerSpec(),),
    qkv_bias=True,
    norm="rmsnorm",
    norm_eps=1.5625e-07,
    ffn_act="silu",
    tie_embeddings=False,
    rope_theta=10_000.0,
)
