"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (task-card dims).

48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840, MoE 64 experts
top-6.  Task card specifies GQA kv=16 and standard attention (the HF release
uses the DeepSeek-V3 layout; we follow the assigned card exactly and note the
difference here).  Every layer is MoE.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    period=(LayerSpec(moe=True),),
    num_experts=64,
    top_k=6,
    norm="rmsnorm",
    ffn_act="silu",
    tie_embeddings=False,
    rope_theta=50_000.0,
)
