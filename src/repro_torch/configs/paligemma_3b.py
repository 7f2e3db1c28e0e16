"""paligemma-3b [vlm] — arXiv:2407.07726; hf:google/paligemma-3b.

Gemma-2B language backbone: 18L d_model=2048 8H (GQA kv=1, head_dim=256)
d_ff=16384 vocab=257216.  The SigLIP vision tower is stubbed:
``models.inputs.input_specs()`` supplies 256 precomputed patch embeddings,
which the model consumes as a prefix (full bidirectional-within-prefix
attention is approximated as causal; loss masked to text positions).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    period=(LayerSpec(),),
    query_scale=256 ** -0.5,
    ffn_act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=10_000.0,
    vision_tokens=256,
)
