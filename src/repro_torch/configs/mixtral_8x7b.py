"""mixtral-8x7b [moe] — arXiv:2401.04088.  The paper's own evaluation model.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2.
Used by every paper-table benchmark (Figs. 4/5/7/9/10, Tabs. 4/5).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    period=(LayerSpec(moe=True),),
    num_experts=8,
    top_k=2,
    norm="rmsnorm",
    ffn_act="silu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
)
