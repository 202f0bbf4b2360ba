"""whisper-base — encoder-decoder audio transformer. [arXiv:2212.04356; unverified]

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 — enc-dec, conv frontend (STUB:
``input_specs()`` provides precomputed 1500-frame embeddings, per assignment).
Attention heads (8) do not divide the 16-way model axis -> attention replicated,
TP on FFN inner dim (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356; unverified",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
    tie_embeddings=True,
    pos_embedding="sinusoidal",
    attention_type="full",
    is_encoder_decoder=True,
    encoder_layers=6,
    encoder_seq=1500,
    shard_attention=False,
)
