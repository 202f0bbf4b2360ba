"""command-r-plus-104b — dense 104B GQA decoder.

[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 — GQA, no-bias.
Cohere models use LayerNorm (no bias) and tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    mlp_type="swiglu",
    norm_type="layernorm",
    use_bias=False,
    tie_embeddings=True,
    attention_type="full",
    parallel_block=True,
)
