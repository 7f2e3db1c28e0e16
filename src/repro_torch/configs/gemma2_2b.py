"""gemma2-2b [dense] — arXiv:2408.00118; hf:google/gemma-2-2b.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Local(4096-window)/global alternating attention, attn-logit softcap 50,
final-logit softcap 30, GeGLU, RMSNorm with post-block norms, embeddings
scaled by sqrt(d_model), tied LM head.
"""
from repro_torch.configs.base import ATTN_FULL, ATTN_WINDOW, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    period=(LayerSpec(attn=ATTN_WINDOW, window=4096),
            LayerSpec(attn=ATTN_FULL)),
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    query_scale=256 ** -0.5,
    ffn_act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    post_block_norm=True,
    rope_theta=10_000.0,
)
