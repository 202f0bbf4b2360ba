"""Model configuration dataclasses.

Every assigned architecture is expressed as a :class:`ModelConfig`. Configs are
pure data with no framework import: this is the port's own copy of
``repro.configs.base``, kept field-for-field identical so a config built by
either package describes the same model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering all assigned families.

    Families: dense | moe | audio (enc-dec) | vlm | hybrid (attn+ssm) | ssm.
    """

    name: str
    family: str
    source: str  # provenance tag from the assignment table

    # Trunk dimensions.
    num_layers: int
    d_model: int
    num_heads: int          # query heads; 0 for attention-free archs
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Block details.
    mlp_type: str = "swiglu"            # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"          # rmsnorm | layernorm | nonparametric_ln
    qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"         # rope | sinusoidal | none

    # Attention pattern.
    attention_type: str = "full"        # full | sliding_window | none
    sliding_window: Optional[int] = None
    parallel_block: bool = False        # x + attn(h) + mlp(h) (Cohere-style)

    # Mixture of experts.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # State-space (Mamba2 SSD) mixers.
    ssm_state_size: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # Encoder-decoder (audio) details.
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0                # precomputed-frame stub length

    # VLM details.
    num_patches: int = 0                # prefix patch embeddings (stub frontend)

    # Precision policy.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # Whether TP may shard attention heads (False when head counts don't divide
    # the model axis — see DESIGN.md §Arch-applicability note iii).
    shard_attention: bool = True

    def __post_init__(self) -> None:
        if self.num_heads and self.num_kv_heads:
            if self.num_heads % self.num_kv_heads != 0:
                raise ValueError(
                    f"{self.name}: num_heads={self.num_heads} not divisible by "
                    f"num_kv_heads={self.num_kv_heads}")
        if self.family == "moe" and self.num_experts <= 0:
            raise ValueError(f"{self.name}: moe family needs num_experts > 0")
        if self.family == "ssm" and self.ssm_state_size <= 0:
            raise ValueError(f"{self.name}: ssm family needs ssm_state_size > 0")

    # ---- Derived quantities -------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state_size else 0

    @property
    def has_attention(self) -> bool:
        return self.attention_type != "none" and self.num_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state_size > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (decode cost independent of context)."""
        if self.is_encoder_decoder:
            return False  # audio context is bounded by encoder_seq anyway
        if not self.has_attention:
            return True   # pure SSM
        return self.attention_type == "sliding_window"

    def num_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qk_norm:
                per_layer += 2 * self.head_dim
        if self.has_ssm:
            di, ns, nh = self.d_inner, self.ssm_state_size, self.ssm_num_heads
            # in_proj -> [z, x, B, C, dt] ; out_proj
            per_layer += d * (2 * di + 2 * ns + nh) + di * d
            per_layer += self.ssm_conv_width * (di + 2 * ns)  # conv over x,B,C
            per_layer += 2 * nh + di  # A_log, dt_bias, D (skip) params
        if f > 0:
            ff_in = 2 * d * f if self.mlp_type in ("swiglu", "geglu") else d * f
            ff = ff_in + f * d
            if self.is_moe:
                per_layer += self.num_experts * ff + d * self.num_experts
            else:
                per_layer += ff
        # norms (rmsnorm scale only; nonparametric has none)
        nrm = d if self.norm_type != "nonparametric_ln" else 0
        per_layer += 2 * nrm
        total = self.num_layers * per_layer
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        if self.is_encoder_decoder:
            enc_layer = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                         + 2 * d * f + 2 * nrm)
            # decoder cross-attention (adds one attention block + norm per layer)
            xattn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + nrm
            total += self.encoder_layers * enc_layer + self.num_layers * xattn
        return total

    def active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        ff = (2 * d * f if self.mlp_type in ("swiglu", "geglu") else d * f) + f * d
        inactive = self.num_layers * (self.num_experts - self.num_experts_per_tok) * ff
        return self.num_params() - inactive
