"""phi3-mini-3.8b — dense decoder. [arXiv:2404.14219; unverified]

32L d_model=3072 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064 — RoPE SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219; unverified",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    attention_type="full",
)
