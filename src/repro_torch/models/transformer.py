"""Decoder-only transformer, dense and MoE families: parameters, prefill
and decode.

Layers are a Python list of per-layer parameter dicts and the forward pass
is a Python loop over them (the reference scans stacked [L, ...] leaves).
An MoE layer runs ``moe.apply_moe`` where a dense layer runs its MLP.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       lm_logits)

INIT_STD = 0.02


PORTED_FAMILIES = ("dense", "moe")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot run yet: the ssm, hybrid, encdec
    and vlm families, and parallel-block (cohere-style) layers."""
    if (cfg.family not in PORTED_FAMILIES or not cfg.has_attention
            or cfg.parallel_block):
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}"
            f"{', parallel block' if cfg.parallel_block else ''}): the port "
            f"runs the dense and moe decoder families; ssm, hybrid, encdec, "
            f"vlm and parallel-block layers are not ported yet")


def _norm_params(cfg: ModelConfig, device) -> dict:
    if cfg.norm_type == "nonparametric_ln":
        return {}
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm_type == "layernorm" and cfg.use_bias:
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Random f32 parameters, N(0, 0.02) for every matrix, drawn from
    ``generator`` on ``device`` (the generator must live there). The tree
    is the reference's ``init_params`` tree with each stacked [L, ...]
    leaf split per layer: qk-norm scales (ones) under ``cfg.qk_norm`` and
    zero attention / MLP biases under ``cfg.use_bias``, as the
    reference's ``attn_params`` and ``mlp_params`` add them."""
    check_ported(cfg)

    def dense(k, n):
        return torch.randn((k, n), generator=generator, device=device) * INIT_STD

    d, f = cfg.d_model, cfg.d_ff
    params = {"embed": {"table": torch.randn(
        (cfg.vocab_size, d), generator=generator, device=device) * INIT_STD}}
    if not cfg.tie_embeddings:
        params["head"] = {"table": torch.randn(
            (cfg.vocab_size, d), generator=generator, device=device) * INIT_STD}
    def const(fill, n):
        return torch.full((n,), fill, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        a = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
             "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
        if cfg.use_bias:
            a.update(bq=const(0.0, cfg.q_dim), bk=const(0.0, cfg.kv_dim),
                     bv=const(0.0, cfg.kv_dim), bo=const(0.0, d))
        if cfg.qk_norm:
            a.update(q_norm=const(1.0, cfg.head_dim),
                     k_norm=const(1.0, cfg.head_dim))
        layer = {"norm1": _norm_params(cfg, device), "attn": a,
                 "norm2": _norm_params(cfg, device)}
        if cfg.is_moe:
            layer["moe"] = moe_mod.moe_params(cfg, generator, device)
        else:
            gated = cfg.mlp_type in ("swiglu", "geglu")
            mlp = ({"wg": dense(d, f), "wu": dense(d, f), "wo": dense(f, d)}
                   if gated else {"wi": dense(d, f), "wo": dense(f, d)})
            if cfg.use_bias:
                mlp.update(bi=const(0.0, f), bo=const(0.0, d))
            layer["mlp"] = mlp
        layers.append(layer)
    params["layers"] = layers
    params["final_norm"] = _norm_params(cfg, device)
    return params


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward on its normed input: MoE or MLP."""
    if cfg.is_moe:
        return moe_mod.apply_moe(cfg, p["moe"], x)[0]
    return apply_mlp(cfg, p["mlp"], x)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, cache_dtype=None
            ) -> Tuple[torch.Tensor, List[dict]]:
    """Prompt processing: (last-position logits [B, V], per-layer caches)."""
    compute = torch_dtype(cfg.compute_dtype)
    cache_dtype = cache_dtype or compute
    x = embed_tokens(cfg, params, tokens, compute)
    b, s = tokens.shape
    max_len = max_len or s
    positions = _positions(b, s, tokens.device)
    caches = []
    for p in params["layers"]:
        a_out, (k, v) = attn.self_attention(
            cfg, p["attn"], apply_norm(cfg, p["norm1"], x), positions,
            return_kv=True)
        caches.append({"kv": attn.cache_from_prefill(cfg, k, v, max_len,
                                                     cache_dtype)})
        x = x + a_out
        x = x + _ffn(cfg, p, apply_norm(cfg, p["norm2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x[:, -1:])[:, 0], caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None) -> List[dict]:
    return [{"kv": attn.init_kv_cache(cfg, batch, max_len, dtype, device)}
            for _ in range(cfg.num_layers)]


def decode(cfg: ModelConfig, params: dict, caches: List[dict],
           token: torch.Tensor, pos: torch.Tensor
           ) -> Tuple[torch.Tensor, List[dict]]:
    """token [B, 1]; pos [B] -> (logits [B, 1, V], caches). The caches are
    updated in place (see ``attention.decode_attention``)."""
    x = embed_tokens(cfg, params, token, torch_dtype(cfg.compute_dtype))
    new_caches = []
    for p, c in zip(params["layers"], caches):
        a_out, kv = attn.decode_attention(
            cfg, p["attn"], apply_norm(cfg, p["norm1"], x), c["kv"], pos)
        new_caches.append({**c, "kv": kv})
        x = x + a_out
        x = x + _ffn(cfg, p, apply_norm(cfg, p["norm2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), new_caches
