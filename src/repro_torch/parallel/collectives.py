"""Manual collective programs, the counterpart of
``repro/parallel/collectives.py``.

``sp_decode_attention``: flash-decode over a KV cache sharded along the
SEQUENCE dim (sequence-parallel serving). Each rank attends over its local
KV slice, then the ranks combine with the numerically-stable flash
rescaling, over the process group of the mesh's ``seq_axis``:

    m   = all_reduce_max(m_local)                    (global running max)
    l   = all_reduce_sum(l_local * exp(m_local - m)) (corrected denominator)
    out = all_reduce_sum(o_local * exp(m_local - m)) / l

One max and two sums of [B, H(, D)]-sized values replace an all-gather of
the whole KV stream. The local attention (:func:`_local_flash`) and the
single-device oracle (:func:`ref_decode_attention`) are plain torch, as
the reference's are plain jnp: this is a collective program, not a kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import is_device_mesh, is_dtensor

_NEG = -1e30


def _local_flash(q, k, v, k_positions, q_positions, window):
    """Unnormalized local attention. q:[B,H,D]; k/v:[B,S_loc,Hkv,D].

    Returns (o_unnorm [B,H,D], l [B,H], m [B,H]), all f32.
    """
    b, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale   # [B,Hkv,G,S_loc]
    kpos = k_positions[:, None, None, :]
    qpos = q_positions[:, None, None, None]
    mask = (kpos <= qpos) & (kpos >= 0)
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, _NEG)
    m = torch.amax(logits, dim=-1)                        # [B,Hkv,G]
    p = torch.exp(logits - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return o.reshape(b, h, d), l.reshape(b, h), m.reshape(b, h)


def _local_slice(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's slice of ``x`` along dim 1 (S): a DTensor's local shard,
    or the rank's contiguous 1/world of a tensor every rank holds whole."""
    if is_dtensor(x):
        return x.to_local()
    s = x.shape[1]
    if s % world:
        raise ValueError(f"KV length {s} does not split over {world} ranks")
    return x[:, rank * (s // world):(rank + 1) * (s // world)]


def sp_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, k_positions: torch.Tensor,
                        q_positions: torch.Tensor, *, mesh,
                        seq_axis: str = "model",
                        window: Optional[int] = None) -> torch.Tensor:
    """One-token attention with the KV cache sharded on seq over
    ``seq_axis`` of the ``DeviceMesh`` ``mesh``.

    q: [B,H,D]; k/v_cache: [B,S,Hkv,D]; k_positions: [B,S] absolute
    positions (-1 => invalid slot); q_positions: [B]. The caches and
    positions are DTensors sharded on S over ``seq_axis`` or plain tensors
    every rank holds whole (each rank then takes its contiguous slice, as
    ``shard_map`` splits them). Returns [B,H,D] in q's dtype, the same on
    every rank. A row whose every slot is masked gets zeros (its
    denominator divides by 1)."""
    if not is_device_mesh(mesh):
        raise TypeError(f"sp_decode_attention needs a DeviceMesh; got "
                        f"{type(mesh).__name__}")
    group = mesh.get_group(seq_axis)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    k_l, v_l, kpos_l = (_local_slice(t, rank, world)
                        for t in (k_cache, v_cache, k_positions))
    o, l, m = _local_flash(q, k_l, v_l, kpos_l, q_positions, window)
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)
    l_glob = l * corr
    dist.all_reduce(l_glob, op=dist.ReduceOp.SUM, group=group)
    o_glob = o * corr[..., None]
    dist.all_reduce(o_glob, op=dist.ReduceOp.SUM, group=group)
    denom = torch.where(l_glob == 0.0, 1.0, l_glob)
    return (o_glob / denom[..., None]).to(q.dtype)


def ref_decode_attention(q, k_cache, v_cache, k_positions, q_positions,
                         window=None):
    """Single-device oracle for sp_decode_attention."""
    o, l, m = _local_flash(q, k_cache, v_cache, k_positions, q_positions,
                           window)
    denom = torch.where(l == 0.0, 1.0, l)
    return (o / denom[..., None]).to(q.dtype)
