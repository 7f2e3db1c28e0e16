"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B (family config per task card).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
GQA with QKV bias, SwiGLU, RMSNorm, RoPE theta 1e6, tied head.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    period=(LayerSpec(),),
    qkv_bias=True,
    norm="rmsnorm",
    ffn_act="silu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
