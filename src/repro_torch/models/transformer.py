"""Decoder-only transformer assembly for the dense / moe / hybrid / ssm /
vlm families: parameters, the train forward, prefill and decode.

Layers are a Python list of per-layer parameter dicts and the forward pass
is a Python loop over them (the reference scans stacked [L, ...] leaves).
A layer's mixer is attention, the Mamba2 SSD block, or (hymba) both over
the same normed input, averaged; a parallel block (command-r) adds
attention and the MLP of one normed input to the residual. An MoE layer
runs ``moe.apply_moe`` where a dense layer runs its MLP. A VLM prefill
takes precomputed patch embeddings as a prefix, attended bidirectionally.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_const, init_normal, lm_logits,
                                       remat_call)


def norm_params(cfg: ModelConfig, device) -> dict:
    if cfg.norm_type == "nonparametric_ln":
        return {}
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm_type == "layernorm" and cfg.use_bias:
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


def attn_params(cfg: ModelConfig, generator: torch.Generator, device, *,
                cross: bool = False) -> dict:
    """The reference's ``attn_params``: wq / wk / wv / wo, zero biases under
    ``cfg.use_bias`` and qk-norm scales (ones) under ``cfg.qk_norm``,
    except for cross attention."""
    d = cfg.d_model
    a = {"wq": init_normal(generator, device, d, cfg.q_dim),
         "wk": init_normal(generator, device, d, cfg.kv_dim),
         "wv": init_normal(generator, device, d, cfg.kv_dim),
         "wo": init_normal(generator, device, cfg.q_dim, d)}
    if cfg.use_bias:
        a.update(bq=init_const(0.0, cfg.q_dim, device),
                 bk=init_const(0.0, cfg.kv_dim, device),
                 bv=init_const(0.0, cfg.kv_dim, device), bo=init_const(0.0, d, device))
    if cfg.qk_norm and not cross:
        a.update(q_norm=init_const(1.0, cfg.head_dim, device),
                 k_norm=init_const(1.0, cfg.head_dim, device))
    return a


def mlp_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Gated (wg / wu / wo) or plain (wi / wo), zero biases under
    ``cfg.use_bias``."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp = {"wg": init_normal(generator, device, d, f),
               "wu": init_normal(generator, device, d, f),
               "wo": init_normal(generator, device, f, d)}
    else:
        mlp = {"wi": init_normal(generator, device, d, f),
               "wo": init_normal(generator, device, f, d)}
    if cfg.use_bias:
        mlp.update(bi=init_const(0.0, f, device), bo=init_const(0.0, d, device))
    return mlp


def embed_params(cfg: ModelConfig, generator: torch.Generator,
                 device) -> dict:
    def table():
        return init_normal(generator, device, cfg.vocab_size, cfg.d_model)
    params = {"embed": {"table": table()}}
    if not cfg.tie_embeddings:
        params["head"] = {"table": table()}
    return params


def layer_params(cfg: ModelConfig, generator: torch.Generator,
                 device) -> dict:
    """One layer of the reference's ``layer_params`` tree."""
    layer = {"norm1": norm_params(cfg, device)}
    if cfg.has_attention:
        layer["attn"] = attn_params(cfg, generator, device)
    if cfg.has_ssm:
        layer["ssm"] = ssm_mod.ssm_params(cfg, generator, device)
    if cfg.d_ff > 0:
        layer["norm2"] = norm_params(cfg, device)
        if cfg.is_moe:
            layer["moe"] = moe_mod.moe_params(cfg, generator, device)
        else:
            layer["mlp"] = mlp_params(cfg, generator, device)
    return layer


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Random f32 parameters, N(0, 0.02) for every matrix, drawn from
    ``generator`` on ``device`` (the generator must live there). The tree
    is the reference's ``init_params`` tree with each stacked [L, ...]
    leaf split per layer, its deterministic leaves (norm scales, qk-norm
    scales, biases, the SSM's ``A_log`` / ``dt_bias`` / ``D``) equal."""
    params = embed_params(cfg, generator, device)
    params["layers"] = [layer_params(cfg, generator, device)
                        for _ in range(cfg.num_layers)]
    params["final_norm"] = norm_params(cfg, device)
    return params


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def prefill_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, prefix_len: int,
                  max_len: Optional[int] = None, cache_dtype=None
                  ) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """One layer over a whole sequence: (x, this layer's decode cache, its
    MoE aux loss). With ``max_len`` None (the train forward) no cache is
    built and the dict is empty."""
    cache: dict = {}
    keep = max_len is not None
    h = apply_norm(cfg, p["norm1"], x)
    a_out = s_out = None
    if cfg.has_attention:
        a_out, (k, v) = attn.self_attention(cfg, p["attn"], h, positions,
                                            prefix_len=prefix_len,
                                            return_kv=True)
        if keep:
            cache["kv"] = attn.cache_from_prefill(cfg, k, v, max_len,
                                                  cache_dtype)
    if cfg.parallel_block:
        return (x + a_out + apply_mlp(cfg, p["mlp"], h), cache,
                _no_aux(x))
    if cfg.has_ssm:
        if keep:
            s_out, cache["ssm"] = ssm_mod.apply_ssm(cfg, p["ssm"], h,
                                                    return_state=True)
        else:
            s_out = ssm_mod.apply_ssm(cfg, p["ssm"], h)
    x, aux = _mix_and_ffn(cfg, p, x, a_out, s_out)
    return x, cache, aux


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _mix_and_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, a_out,
                 s_out) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual after the mixer (hymba averages its two paths), then
    the feed-forward on the second norm, where the layer has one: (x, the
    MoE aux loss, 0 for a dense layer)."""
    aux = _no_aux(x)
    if a_out is not None and s_out is not None:
        x = x + 0.5 * (a_out + s_out)
    else:
        x = x + (a_out if a_out is not None else s_out)
    if cfg.d_ff > 0:
        h2 = apply_norm(cfg, p["norm2"], x)
        if cfg.is_moe:
            out, aux, _ = moe_mod.apply_moe(cfg, p["moe"], h2)
            x = x + out
        else:
            x = x + apply_mlp(cfg, p["mlp"], h2)
    return x, aux


def run_layers(cfg: ModelConfig, layers: List[dict], x: torch.Tensor,
               positions: torch.Tensor, prefix_len: int = 0,
               remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer over the whole sequence: (x, the summed MoE aux loss).
    ``remat`` recomputes each layer in the backward
    (:func:`layers.remat_call`); the values do not change."""
    def layer(p, h):
        out, _, aux = prefill_block(cfg, p, h, positions, prefix_len)
        return out, aux

    auxes = []
    for p in layers:
        x, aux = remat_call(layer, remat, p, x)
        auxes.append(aux)
    return x, torch.stack(auxes).sum() if auxes else _no_aux(x)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S(+P), V] f32, the summed MoE aux
    loss). ``prefix_embeds`` [B, P, d] (the VLM's patch embeddings) go
    before the tokens and attend to each other both ways."""
    compute = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(cfg, params, tokens, compute)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(compute), x], dim=1)
    b, s, _ = x.shape
    x, aux = run_layers(cfg, params["layers"], x, _positions(b, s, x.device),
                        prefix_len=prefix_len, remat=remat)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, cache_dtype=None
            ) -> Tuple[torch.Tensor, List[dict]]:
    """Prompt processing: (last-position logits [B, V], per-layer caches).
    ``prefix_embeds`` [B, P, d] (the VLM's patch embeddings) go before the
    tokens and attend to each other both ways; ``max_len`` must hold them
    too."""
    compute = torch_dtype(cfg.compute_dtype)
    cache_dtype = cache_dtype or compute
    x = embed_tokens(cfg, params, tokens, compute)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(compute), x], dim=1)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = _positions(b, s, tokens.device)
    caches = []
    for p in params["layers"]:
        x, cache, _ = prefill_block(cfg, p, x, positions, prefix_len,
                                    max_len, cache_dtype)
        caches.append(cache)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x[:, -1:])[:, 0], caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device=None) -> List[dict]:
    def one_layer():
        c = {}
        if cfg.has_attention:
            c["kv"] = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
        if cfg.has_ssm:
            c["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, device)
        return c
    return [one_layer() for _ in range(cfg.num_layers)]


def decode_block(cfg: ModelConfig, p: dict, cache: dict, x: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One layer for one token against its cache."""
    new_cache = dict(cache)
    h = apply_norm(cfg, p["norm1"], x)
    a_out = s_out = None
    if cfg.has_attention:
        a_out, new_cache["kv"] = attn.decode_attention(cfg, p["attn"], h,
                                                       cache["kv"], pos)
    if cfg.parallel_block:
        return x + a_out + apply_mlp(cfg, p["mlp"], h), new_cache
    if cfg.has_ssm:
        s_out, new_cache["ssm"] = ssm_mod.decode_ssm(cfg, p["ssm"], h,
                                                     cache["ssm"])
    return _mix_and_ffn(cfg, p, x, a_out, s_out)[0], new_cache


def decode(cfg: ModelConfig, params: dict, caches: List[dict],
           token: torch.Tensor, pos: torch.Tensor
           ) -> Tuple[torch.Tensor, List[dict]]:
    """token [B, 1]; pos [B] -> (logits [B, 1, V], caches). The KV caches
    are updated in place (see ``attention.decode_attention``); an SSM
    layer's state and conv window are new tensors."""
    x = embed_tokens(cfg, params, token, torch_dtype(cfg.compute_dtype))
    new_caches = []
    for p, c in zip(params["layers"], caches):
        x, c = decode_block(cfg, p, c, x, pos)
        new_caches.append(c)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), new_caches
