"""hymba-1.5b — hybrid: parallel attention + mamba heads in each layer.

[arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Hymba fuses attention heads and SSM heads in the same block and uses sliding-
window attention for most layers -> sub-quadratic, runs long_500k.
25 heads do not divide the 16-way model axis -> attention replicated, TP on
FFN/SSM inner dims (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676; hf",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    attention_type="sliding_window",
    sliding_window=1024,
    ssm_state_size=16,
    ssm_head_dim=50,   # d_inner = 2*1600 = 3200 -> 64 SSD heads of dim 50
    ssm_expand=2,
    shard_attention=False,
)
