"""olmo-1b [dense] — arXiv:2402.00838; hf:allenai/OLMo-1B.

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (no learned scale/bias), SwiGLU, RoPE, tied head,
no biases anywhere.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    period=(LayerSpec(),),
    norm="nonparametric_ln",
    norm_eps=1e-5,
    ffn_act="silu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)
