"""mamba2-130m — attention-free SSD (state-space duality). [arXiv:2405.21060; unverified]

24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads. No FFN (d_ff=0): the Mamba2
block is the whole layer. Runs long_500k (decode cost independent of context).
At 130M params tensor parallelism is not applied (replicated weights, DP/FSDP
only) — the production-sane choice; see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    norm_type="rmsnorm",
    tie_embeddings=True,
    attention_type="none",
    ssm_state_size=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    shard_attention=False,
)
