"""Attention blocks (GQA / MQA / MHA, RoPE, qk-norm), cross attention
against an encoder's K / V, and the decode KV cache.

Projections go through ``repro_torch.core.gemm.linear``; the score and value
contractions use the plain-torch ``layers.chunked_attention``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gemm
from repro_torch.core.contraction import as_compute_weight
from repro_torch.models.layers import apply_rope, chunked_attention
from repro_torch.parallel.mesh import (grad_split_ready, is_dtensor, shard,
                                       split_ready)


def _window(cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window if cfg.attention_type == "sliding_window" else None


def _heads_axis(cfg: ModelConfig) -> Optional[str]:
    """The logical axis of the heads: tensor parallel where the head
    counts divide it (``cfg.shard_attention``)."""
    return "model" if cfg.shard_attention else None


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor], rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> q [B,S,H,D], k/v [B,S,Hkv,D] (RoPE + qk-norm applied)."""
    b, s, _ = x.shape
    q = gemm.linear(x, as_compute_weight(p["wq"], x.dtype), p.get("bq"))
    k = gemm.linear(x, as_compute_weight(p["wk"], x.dtype), p.get("bk"))
    v = gemm.linear(x, as_compute_weight(p["wv"], x.dtype), p.get("bv"))
    q = split_ready(q, cfg.num_heads).reshape(b, s, cfg.num_heads,
                                              cfg.head_dim)
    k = split_ready(k, cfg.num_kv_heads).reshape(b, s, cfg.num_kv_heads,
                                                 cfg.head_dim)
    v = split_ready(v, cfg.num_kv_heads).reshape(b, s, cfg.num_kv_heads,
                                                 cfg.head_dim)
    q = shard(q, "batch", None, _heads_axis(cfg))
    if "q_norm" in p:
        q = _rms(q, p["q_norm"])
        k = _rms(k, p["k_norm"])
    if rope and cfg.pos_embedding == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   positions: torch.Tensor, *, causal: bool = True,
                   prefix_len: int = 0, return_kv: bool = False):
    """Full-sequence self attention (prefill)."""
    q, k, v = project_qkv(cfg, p, x, positions)
    out = chunked_attention(q, k, v, causal=causal, window=_window(cfg),
                            prefix_len=prefix_len)
    out = grad_split_ready(out.reshape(*x.shape[:-1], cfg.q_dim),
                           cfg.num_heads)
    out = shard(out, "batch", None, _heads_axis(cfg))
    out = gemm.linear(out, as_compute_weight(p["wo"], x.dtype), p.get("bo"))
    # Megatron-SP epilogue: the TP-partial output projection reduce-scatters
    # into the seq-sharded residual stream.
    out = shard(out, "batch", "seq")
    return (out, (k, v)) if return_kv else out


def cache_from_prefill(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                       max_len: int, dtype, out: Optional[dict] = None
                       ) -> dict:
    """The decode ring-buffer cache from prefill K/V [B,S,Hkv,D]: slot s
    holds the latest position congruent to s (mod slots). ``out`` (a cache
    of this layer, of ``dtype``) takes it in place and is returned."""
    b, s, hkv, d = k.shape
    window = _window(cfg)
    slots = min(max_len, window) if window else max_len
    if slots >= s and out is None and is_dtensor(k):
        # A mesh's layout: built out of place (a DTensor cannot be written
        # into a plain buffer).
        def fill(t):
            t = t.to(dtype)
            return t if slots == s else torch.cat(
                [t, t.new_zeros((b, slots - s, hkv, d))], dim=1)
        return {"k": fill(k), "v": fill(v)}
    if slots >= s:
        if out is None:
            shape = (b, slots, hkv, d)
            out = {"k": torch.zeros(shape, dtype=dtype, device=k.device),
                   "v": torch.zeros(shape, dtype=dtype, device=k.device)}
        else:
            out["k"][:, s:].zero_()
            out["v"][:, s:].zero_()
        out["k"][:, :s] = k
        out["v"][:, :s] = v
        return out
    slot_ids = torch.arange(slots, device=k.device)
    src = (s - 1) - ((s - 1 - slot_ids) % slots)
    if out is None:
        return {"k": k[:, src].to(dtype), "v": v[:, src].to(dtype)}
    out["k"].copy_(k[:, src])
    out["v"].copy_(v[:, src])
    return out


def cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross attention against precomputed encoder K / V
    [B, Se, Hkv, D]: every query sees every encoder position."""
    b, s, _ = x.shape
    q = gemm.linear(x, as_compute_weight(p["wq"], x.dtype), p.get("bq"))
    q = split_ready(q, cfg.num_heads).reshape(b, s, cfg.num_heads,
                                              cfg.head_dim)
    out = chunked_attention(q, enc_k, enc_v, causal=False)
    out = grad_split_ready(out.reshape(b, s, cfg.q_dim), cfg.num_heads)
    return gemm.linear(out, as_compute_weight(p["wo"], x.dtype), p.get("bo"))


def encode_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor):
    """Cross-attention K / V [B, Se, Hkv, D] from the encoder's output,
    computed once a request."""
    b, se, _ = enc_out.shape
    k = gemm.linear(enc_out, as_compute_weight(p["wk"], enc_out.dtype),
                    p.get("bk"))
    v = gemm.linear(enc_out, as_compute_weight(p["wv"], enc_out.dtype),
                    p.get("bv"))
    return (split_ready(k, cfg.num_kv_heads).reshape(
                b, se, cfg.num_kv_heads, cfg.head_dim),
            split_ready(v, cfg.num_kv_heads).reshape(
                b, se, cfg.num_kv_heads, cfg.head_dim))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None) -> dict:
    """Cache for one layer; sliding-window archs keep ``window`` slots."""
    window = _window(cfg)
    slots = min(max_len, window) if window else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _one_hot_write(buf: torch.Tensor, new: torch.Tensor,
                   slot: torch.Tensor) -> torch.Tensor:
    """``buf`` [B, slots, H, D] with row b's slot ``slot[b]`` replaced by
    ``new[b, 0]``, out of place: ``buf * keep + new * onehot``."""
    ids = torch.arange(buf.shape[1], device=slot.device)
    onehot = (slot[:, None] == ids).to(buf.dtype)[:, :, None, None]
    return buf * (1 - onehot) + new.to(buf.dtype) * onehot


def decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache: dict, pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token self attention. x: [B,1,d]; pos: [B] absolute position.

    The cache is a ring buffer: slot s holds absolute position
    ``pos - ((pos - s) mod slots)``. Unlike the reference, which builds a
    new cache array each step, the new K/V row is written IN PLACE into the
    cache tensors passed in (the returned dict holds the same tensors)."""
    b = x.shape[0]
    window = _window(cfg)
    q, k_new, v_new = project_qkv(cfg, p, x, pos[:, None])
    slots = cache["k"].shape[1]
    slot = pos % slots
    if is_dtensor(cache["k"]):
        # A mesh's layout (the sequence sharded): the reference's one-hot
        # write, out of place, where an indexed write would gather.
        cache = {n: _one_hot_write(cache[n], new, slot)
                 for n, new in (("k", k_new), ("v", v_new))}
    else:
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    k_cache = shard(cache["k"], "batch", "kv_seq")
    v_cache = shard(cache["v"], "batch", "kv_seq")

    slot_ids = torch.arange(slots, device=x.device)[None, :]
    posb = pos[:, None]
    k_positions = posb - ((posb - slot_ids) % slots)
    kv_valid = k_positions >= 0
    if window is not None:
        kv_valid &= (posb - k_positions) < window
    out = chunked_attention(q, k_cache, v_cache, causal=True,
                            q_positions=pos[:, None], k_positions=k_positions,
                            kv_valid=kv_valid, chunk=1)
    out = out.reshape(b, 1, cfg.q_dim)
    out = gemm.linear(out, as_compute_weight(p["wo"], x.dtype), p.get("bo"))
    return out, cache
