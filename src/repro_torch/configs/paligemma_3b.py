"""paligemma-3b — VLM: SigLIP frontend (STUB) + gemma backbone. [arXiv:2407.07726; hf]

18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216.
``input_specs()`` provides 256 precomputed patch embeddings as a prefix, per the
assignment ("the modality frontend is a STUB").
8 heads / 1 KV head do not divide the 16-way model axis -> attention replicated,
TP on FFN inner dim (16384/16=1024).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726; hf",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="geglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    attention_type="full",
    num_patches=256,
    shard_attention=False,
)
