"""Encoder-decoder (Whisper-style) assembly.

The conv frontend is a stub, as in the reference: the caller hands in
precomputed frame embeddings [B, encoder_seq, d_model] (what the two conv
layers would emit). The bidirectional encoder, the causal decoder with
cross attention, and their sinusoidal positions are in full. Layers are
Python lists of per-layer dicts (the reference scans stacked leaves);
every projection goes through ``core.gemm.linear``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtypes import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       lm_logits, remat_call,
                                       sinusoidal_embedding)
from repro_torch.models.transformer import (attn_params, embed_params,
                                            mlp_params, norm_params)


def _enc_layer_params(cfg: ModelConfig, generator, device) -> dict:
    return {"norm1": norm_params(cfg, device),
            "attn": attn_params(cfg, generator, device),
            "norm2": norm_params(cfg, device),
            "mlp": mlp_params(cfg, generator, device)}


def _dec_layer_params(cfg: ModelConfig, generator, device) -> dict:
    return {"norm1": norm_params(cfg, device),
            "attn": attn_params(cfg, generator, device),
            "norm2": norm_params(cfg, device),
            "xattn": attn_params(cfg, generator, device, cross=True),
            "norm3": norm_params(cfg, device),
            "mlp": mlp_params(cfg, generator, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """The reference's tree: embeddings, ``encoder`` {"layers" (a list of
    ``cfg.encoder_layers``), "final_norm"}, the decoder's ``layers`` and
    ``final_norm``; random matrices N(0, 0.02) from ``generator``."""
    params = embed_params(cfg, generator, device)
    params["encoder"] = {
        "layers": [_enc_layer_params(cfg, generator, device)
                   for _ in range(cfg.encoder_layers)],
        "final_norm": norm_params(cfg, device)}
    params["layers"] = [_dec_layer_params(cfg, generator, device)
                        for _ in range(cfg.num_layers)]
    params["final_norm"] = norm_params(cfg, device)
    return params


def _with_positions(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    pe = sinusoidal_embedding(x.shape[1], cfg.d_model, x.device)
    return x + pe.to(x.dtype)[None]


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """frames [B, Se, d] (the stub frontend's embeddings) -> the encoder's
    output [B, Se, d] in the compute dtype. ``remat`` recomputes each layer
    in the backward (:func:`layers.remat_call`)."""
    x = _with_positions(cfg, frames.to(torch_dtype(cfg.compute_dtype)))

    def layer(lp, c):
        h = apply_norm(cfg, lp["norm1"], c)
        c = c + attn.self_attention(cfg, lp["attn"], h, positions=None,
                                    causal=False)
        return c + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm2"], c))

    for lp in params["encoder"]["layers"]:
        x = remat_call(layer, remat, lp, x)
    return apply_norm(cfg, params["encoder"]["final_norm"], x)


def _dec_block(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               enc_k: torch.Tensor, enc_v: torch.Tensor,
               positions: torch.Tensor):
    """One decoder layer over the prompt: (x, this layer's self K / V)."""
    h = apply_norm(cfg, lp["norm1"], x)
    a_out, kv = attn.self_attention(cfg, lp["attn"], h, positions,
                                    causal=True, return_kv=True)
    x = x + a_out
    h = apply_norm(cfg, lp["norm2"], x)
    x = x + attn.cross_attention(cfg, lp["xattn"], h, enc_k, enc_v)
    x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm3"], x))
    return x, kv


def forward(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train forward: (logits [B, S, V] f32, aux = 0). The encoder runs
    once; each decoder layer projects its cross K / V from its output."""
    compute = torch_dtype(cfg.compute_dtype)
    enc_out = encode(cfg, params, frames, remat=remat)
    b, s = tokens.shape
    x = _with_positions(cfg, embed_tokens(cfg, params, tokens, compute))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)

    def layer(lp, c):
        enc_k, enc_v = attn.encode_kv(cfg, lp["xattn"], enc_out)
        return _dec_block(cfg, lp, c, enc_k, enc_v, positions)[0]

    for lp in params["layers"]:
        x = remat_call(layer, remat, lp, x)
    x = apply_norm(cfg, params["final_norm"], x)
    return (lm_logits(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(cfg: ModelConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, *, max_len: Optional[int] = None,
            cache_dtype=None) -> Tuple[torch.Tensor, List[dict]]:
    """Encoder pass, then the decoder's prompt: (last-position logits
    [B, V], per-layer caches {"kv", "cross_k", "cross_v"})."""
    compute = torch_dtype(cfg.compute_dtype)
    cache_dtype = cache_dtype or compute
    enc_out = encode(cfg, params, frames, remat=False)
    b, s = tokens.shape
    max_len = max_len or s
    x = _with_positions(cfg, embed_tokens(cfg, params, tokens, compute))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    caches = []
    for lp in params["layers"]:
        ck, cv = attn.encode_kv(cfg, lp["xattn"], enc_out)
        x, (k, v) = _dec_block(cfg, lp, x, ck, cv, positions)
        caches.append({"kv": attn.cache_from_prefill(cfg, k, v, max_len,
                                                     cache_dtype),
                       "cross_k": ck.to(cache_dtype),
                       "cross_v": cv.to(cache_dtype)})
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x[:, -1:])[:, 0], caches


def init_caches(cfg: ModelConfig, params: dict, frames: torch.Tensor,
                max_len: int, dtype) -> List[dict]:
    """Empty self-attention caches, with the cross K / V computed once from
    the encoder's output."""
    enc_out = encode(cfg, params, frames, remat=False)
    caches = []
    for lp in params["layers"]:
        k, v = attn.encode_kv(cfg, lp["xattn"], enc_out)
        caches.append({"kv": attn.init_kv_cache(cfg, frames.shape[0], max_len,
                                                dtype, frames.device),
                       "cross_k": k.to(dtype), "cross_v": v.to(dtype)})
    return caches


def decode(cfg: ModelConfig, params: dict, caches: List[dict],
           token: torch.Tensor, pos: torch.Tensor
           ) -> Tuple[torch.Tensor, List[dict]]:
    """token [B, 1]; pos [B] -> (logits [B, 1, V], caches). The positional
    table has one row more than the self-attention cache has slots, and
    ``pos`` is clamped into it, as the reference does; the self-attention
    cache is written in place, the cross K / V are read only."""
    compute = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(cfg, params, token, compute)
    slots = caches[0]["kv"]["k"].shape[1]
    pos_emb = sinusoidal_embedding(slots + 1, cfg.d_model, x.device).to(compute)
    x = x + pos_emb[torch.clamp(pos, max=slots)][:, None]
    new_caches = []
    for lp, lc in zip(params["layers"], caches):
        h = apply_norm(cfg, lp["norm1"], x)
        a_out, kv = attn.decode_attention(cfg, lp["attn"], h, lc["kv"], pos)
        x = x + a_out
        h = apply_norm(cfg, lp["norm2"], x)
        x = x + attn.cross_attention(cfg, lp["xattn"], h, lc["cross_k"],
                                     lc["cross_v"])
        x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm3"], x))
        new_caches.append({**lc, "kv": kv})
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), new_caches
