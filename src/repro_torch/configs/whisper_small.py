"""whisper-small [audio] — arXiv:2212.04356.

Enc-dec, 12L encoder + 12L decoder, d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  The conv frontend is stubbed: ``models.inputs.input_specs()``
supplies precomputed 1500-frame embeddings; the encoder is the transformer
stack over those frames, the decoder cross-attends every layer.  LayerNorm,
plain GELU MLP, learned positions.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    period=(LayerSpec(cross_attn=True),),
    encoder_layers=12,
    encoder_seq=1500,
    norm="layernorm",
    norm_eps=1e-5,
    ffn_act="gelu_mlp",
    pos="learned",
    tie_embeddings=True,
)
