"""llama4-scout-17b-a16e — MoE decoder, 16 experts top-1.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
"Early fusion" multimodality: the assignment specifies the transformer backbone
only; vision fusion is out of scope (text token path implemented).
16 experts divide the 16-way model axis -> true expert parallelism (EP).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    attention_type="full",
    num_experts=16,
    num_experts_per_tok=1,
)
