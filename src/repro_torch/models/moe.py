"""Mixture-of-experts FFN with grouped, capacity-bounded dense dispatch.

GShard/Switch-style routing, as the reference: tokens are split into groups
of at most ``GROUP_SIZE``, routed top-k within each group, and dispatched to
experts through one-hot capacity tensors [G, g, E, C]. Tokens past an
expert's capacity C are dropped, and counted.

The two expert contractions of a layer — the gate/up pair fused into one
silu-gate pass, then the down projection — are declared as grouped
:class:`~repro_torch.core.contraction.ContractionSpec` s and run through
the one dispatch point (``core.gemm.contract``). Raw [E, K, N] stacks take
the ``grouped_einsum`` lowering; load-time-packed stacks
(:class:`~repro_torch.core.layered.GroupedPackedWeight`, made by
``layers.pack_model_params``) declare the routing counts too, so on the
card both contractions launch the ragged grouped kernel, whose blocks past
an expert's count load nothing. The router is a raw f32 product, and the
dispatch / combine einsums are plain torch, as the reference leaves them to
XLA.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.contraction import (ContractionSpec, as_compute_weight,
                                          is_packed)
from repro_torch.core.epilogue import EPILOGUE_SPECS
from repro_torch.core.gemm import contract
from repro_torch.models.layers import init_normal
from repro_torch.parallel.mesh import (gather_inner_dims, keep_shards, shard,
                                       split_ready)

GROUP_SIZE = 2048  # routing group (tokens); bounds the dispatch tensor


def moe_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random f32 router [d, E] and expert stacks wg/wu [E, d, f], wo
    [E, f, d], N(0, 0.02), drawn from ``generator`` on ``device``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def draw(*shape):
        return init_normal(generator, device, *shape)

    return {"router": draw(d, e), "wg": draw(e, d, f), "wu": draw(e, d, f),
            "wo": draw(e, f, d)}


def _capacity(group: int, cfg: ModelConfig) -> int:
    c = int(group * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)  # the reference pads to a sublane multiple


def _top_k(logits: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the LOWER index (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router_w: torch.Tensor, x_grp: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """x_grp [G, g, d] -> (dispatch [G, g, E, C] int32, combine
    [G, g, E, C] f32, aux loss, stats).

    A (token, choice)'s position in its expert's queue is the running count
    over the group flattened token-major, so the kept slots are a prefix of
    each expert's capacity. ``stats``: ``counts`` [G, E] int32 occupied
    slots per (group, expert) — the ragged GEMM's valid rows — and
    ``dropped`` () int32 assignments past capacity."""
    n_groups, g_tokens, _ = x_grp.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = _capacity(g_tokens, cfg)

    logits = torch.einsum("gtd,de->gte", x_grp.to(torch.float32),
                          router_w.to(torch.float32))
    top, experts = _top_k(logits, k)                          # [G, g, k]
    weights = torch.softmax(top, dim=-1)                      # mixtral renorm

    onehot = F.one_hot(experts, e).to(torch.int32)            # [G, g, k, E]
    flat = onehot.reshape(n_groups, g_tokens * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n_groups, g_tokens, k, e)
    keep = (pos < cap).to(torch.int32) * onehot               # drop overflow
    # A token picks an expert at most once: fold k before the capacity
    # one-hot, so the dispatch tensor stays 4-D.
    pos_e = (pos * keep).sum(dim=2)                           # [G, g, E]
    chosen = keep.sum(dim=2)                                  # [G, g, E]
    gate_e = (weights[..., None] * keep).sum(dim=2)           # [G, g, E]
    dispatch = chosen[..., None] * F.one_hot(pos_e.long(), cap).to(torch.int32)
    combine = gate_e[..., None] * dispatch                    # [G, g, E, C]
    # Switch load-balancing loss: E * mean(frac_tokens * frac_probs).
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = onehot.sum(dim=2).to(torch.float32).mean(dim=1)   # [G, E]
    frac_probs = probs.mean(dim=1)                                  # [G, E]
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    counts = chosen.sum(dim=1).to(torch.int32)                # [G, E]
    dropped = (onehot.sum() - keep.sum()).to(torch.int32)
    return dispatch, combine, aux, {"counts": counts, "dropped": dropped}


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """x [B, S, d] -> (out [B, S, d], aux loss, stats) with stats
    ``dropped_tokens`` () int32 and ``expert_counts`` [G, E] int32."""
    b, s, d = x.shape
    tokens = b * s
    g = min(GROUP_SIZE, tokens)
    assert tokens % g == 0, (tokens, g)
    # Under a mesh the tokens fold into groups along one plain shard.
    x = split_ready(gather_inner_dims(x, x.ndim - 1), tokens // g, dim=0)
    x_grp = shard(x.reshape(tokens // g, g, d), "batch")

    # The router is cast to the compute dtype first, as the reference casts
    # every matrix leaf of a layer before its scan, then routed in f32.
    router = as_compute_weight(p["router"], x.dtype)
    dispatch, combine, aux, rstats = route(cfg, router, x_grp)
    counts = rstats["counts"]
    # Under a mesh the routing tensors keep only their group shards, so
    # that the dispatch / combine einsums fold no uneven (capacity) shard.
    dispatch = keep_shards(dispatch.to(x.dtype), (0,))
    combine = keep_shards(combine.to(x.dtype), (0,))
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, x_grp)
    expert_in = shard(expert_in, "batch", "model")  # EP when E divides axis

    wg = as_compute_weight(p["wg"], x.dtype)
    wu = as_compute_weight(p["wu"], x.dtype)
    wo = as_compute_weight(p["wo"], x.dtype)
    # Packed stacks declare the routing counts (ragged: the kernel skips the
    # padding); raw stacks pin the batched einsum. Padding rows of
    # expert_in are zero, so both agree (silu(0) * 0 == 0, 0 @ wo == 0).
    packed = is_packed(wg)
    strategy = "auto" if packed else "grouped_einsum"
    rcounts = counts if packed else None
    cap = dispatch.shape[-1]
    occ = min(1.0, g * cfg.num_experts_per_tok / max(cfg.num_experts * cap, 1))

    def gspec(xx, w, epilogue):
        return ContractionSpec.grouped(
            cfg.num_experts, xx.shape[0] * xx.shape[2], xx.shape[-1],
            w.n if packed else w.shape[-1], xx.dtype, w=w, epilogue=epilogue,
            counts=rcounts is not None, occupancy=occ)

    h = contract(gspec(expert_in, wg, EPILOGUE_SPECS["silu_gate"]),
                 expert_in, wg, w2=wu, counts=rcounts, strategy=strategy)
    expert_out = contract(gspec(h, wo, EPILOGUE_SPECS["none"]), h, wo,
                          counts=rcounts, strategy=strategy)
    out = torch.einsum("gtec,gecd->gtd", combine,
                       keep_shards(expert_out, (0, 1)))
    out = split_ready(out, b, dim=0).reshape(b, s, d)
    # The TP / EP-partial combine reduce-scatters into the seq-sharded
    # residual stream.
    out = shard(out, "batch", "seq")
    stats = {"dropped_tokens": rstats["dropped"], "expert_counts": counts}
    return out, aux.to(torch.float32), stats
