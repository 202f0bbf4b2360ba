"""olmo-1b — dense decoder with non-parametric LayerNorm. [arXiv:2402.00838; hf]

16L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838; hf",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    mlp_type="swiglu",
    norm_type="nonparametric_ln",
    tie_embeddings=True,
    attention_type="full",
)
