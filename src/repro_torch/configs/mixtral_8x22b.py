"""mixtral-8x22b — MoE decoder, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088; hf",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    attention_type="sliding_window",
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
)
