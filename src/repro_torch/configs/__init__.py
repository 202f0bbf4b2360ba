"""Config registry of the port: ``get_config(arch_id)``, ``all_configs()``
and ``reduced_config``.

The port carries its own copy of every config of the reference, field for
field, registered in the reference's order (``ARCH_IDS`` is the same list).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import (SHAPES, InputShape,  # noqa: F401
                                        iter_cells, shape_applicability)
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r_plus
from repro_torch.configs.phi3_mini_3p8b import CONFIG as _phi3
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.hymba_1p5b import CONFIG as _hymba
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2

_REGISTRY: Dict[str, ModelConfig] = {
    cfg.name: cfg
    for cfg in (
        _command_r_plus, _phi3, _qwen3, _olmo, _mixtral,
        _llama4, _whisper, _paligemma, _hymba, _mamba2,
    )
}

ARCH_IDS: List[str] = list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return _REGISTRY[arch]


def all_configs() -> List[ModelConfig]:
    """Every registered config, in ``ARCH_IDS`` order."""
    return list(_REGISTRY.values())


def reduced_config(arch: str) -> ModelConfig:
    """A smoke-test-sized config of the same family (CPU-runnable): the same
    cut as the reference's ``reduced_config``, field for field."""
    cfg = get_config(arch)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kvh = min(cfg.num_kv_heads, heads) if heads else 0
    if heads and kvh and heads % kvh:
        kvh = 1
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kvh,
        head_dim=16 if heads else 0,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        ssm_state_size=min(cfg.ssm_state_size, 16),
        ssm_head_dim=16 if cfg.ssm_state_size else cfg.ssm_head_dim,
        sliding_window=64 if cfg.sliding_window else None,
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_seq=24 if cfg.is_encoder_decoder else 0,
        num_patches=8 if cfg.num_patches else 0,
    )
    return dataclasses.replace(cfg, **changes)
