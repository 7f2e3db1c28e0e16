"""deepseek-v3-671b [moe] — arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.  MLA attention
(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128), MoE with
1 shared + 256 routed experts top-8 (sigmoid routing w/ normalization),
first 3 layers dense FFN with d_ff=18432.  The MTP auxiliary head is not
implemented (orthogonal to the reproduced paper).
"""
from repro_torch.configs.base import ATTN_MLA, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,     # MLA: logical kv heads == query heads
    head_dim=192,         # qk_nope + qk_rope
    d_ff=2048,
    dense_d_ff=18_432,
    vocab_size=129_280,
    prologue=(LayerSpec(attn=ATTN_MLA),) * 3,
    period=(LayerSpec(attn=ATTN_MLA, moe=True),),
    num_experts=256,
    top_k=8,
    num_shared_experts=1,
    router_scale=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    norm="rmsnorm",
    ffn_act="silu",
    tie_embeddings=False,
    rope_theta=10_000.0,
)
