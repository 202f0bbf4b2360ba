"""Plain-torch oracles: the plain products (dense, grouped and the grouped
silu-gate pair), the packers (A, B and grouped B), the unpack / dequant / fused-A accumulation / ragged references the GEMM
kernels are held against, and the softmax attention oracle. Buffers and
scale grids are byte-identical to the JAX package's ``repro.kernels.ref``
for the same :class:`TileFormat`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.tile_format import (TileFormat, as_tile_format,
                                          pack_nibbles, quantize_tiles,
                                          unpack_nibbles)
from repro_torch.kernels.common import KERNEL_EPILOGUES, pad2d, plain_acc


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None):
    """C = A @ B on the accumulator type (f32, or i32 for integers), cast to
    ``out_dtype`` (default A's dtype)."""
    return plain_acc(a, b).to(out_dtype or a.dtype)


def gemm_ref(a, b, c, alpha: float = 1.0, beta: float = 1.0, out_dtype=None):
    """Full GEMM semantics: C <- alpha * A@B + beta * C (paper Alg. 1)."""
    out = alpha * plain_acc(a, b).to(torch.float32) \
        + beta * c.to(torch.float32)
    return out.to(out_dtype or c.dtype)


def pack_a_ref(a: torch.Tensor, bm: int, bk: int, layout: str = "row"):
    """Pack A[M, K] into tile-major [Mb, Kb, bm, bk] ("row") or [Mb, Kb, bk,
    bm] ("col"), tiles in row-of-tiles order, zero-padded to whole tiles."""
    if layout not in ("row", "col"):
        raise ValueError(f"bad layout {layout!r}")
    a = pad2d(a, bm, bk)
    mb, kb = a.shape[0] // bm, a.shape[1] // bk
    t = a.reshape(mb, bm, kb, bk).permute(0, 2, 1, 3)
    if layout == "col":
        t = t.transpose(2, 3)
    return t.contiguous()


def unpack_a_ref(ap: torch.Tensor, m: int, k: int,
                 layout: str = "row") -> torch.Tensor:
    """Tile-major A stack -> natural [M, K]."""
    if layout == "col":
        ap = ap.transpose(2, 3)
    mb, kb, bm, bk = ap.shape
    return ap.permute(0, 2, 1, 3).reshape(mb * bm, kb * bk)[:m, :k]


def packed_matmul_ref(ap, bp, m: int, n: int, layout_a: str = "row",
                      layout_b: str = "row", out_dtype=None) -> torch.Tensor:
    """unpack(A) @ unpack(B) over the whole padded depth Kb * bk."""
    kdim = ap.shape[1] * ap.shape[3 if layout_a == "row" else 2]
    a = unpack_a_ref(ap, m, kdim, layout_a)
    b = unpack_b_ref(bp, kdim, n, layout_b)
    return matmul_ref(a, b, out_dtype=out_dtype)


def pack_b_ref(b: torch.Tensor, bk, bn: Optional[int] = None,
               layout: str = "row"):
    """Pack B[..., K, N] into [..., Nb, Kb, bk, bn] (row) / [..., Nb, Kb,
    bn, bk] (col), zero-filling the ragged edges; leading dims (an expert
    stack) pack alike in one copy. ``bk`` may be a :class:`TileFormat`. A
    quantized format returns ``(packed, scales)``, scales [..., Nb, Kb]
    (or [..., Nb] per column); int4 tiles are nibble-packed along the
    trailing tile axis as the last step."""
    fmt = as_tile_format(bk, bn, layout=layout, dtype=b.dtype)
    lead, (k, n) = b.shape[:-2], b.shape[-2:]
    pk, pn = (-k) % fmt.bk, (-n) % fmt.bn
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    kb, nb = (k + pk) // fmt.bk, (n + pn) // fmt.bn
    d = len(lead)
    t = b.reshape(*lead, kb, fmt.bk, nb, fmt.bn).permute(
        *range(d), d + 2, d, d + 1, d + 3)
    scales = None
    if fmt.is_quantized:
        assert b.dtype.is_floating_point, (
            f"quantized packing consumes float weights; got {b.dtype}")
        t, scales = quantize_tiles(t, fmt)
    if fmt.layout == "col":
        t = t.transpose(-2, -1)
    if fmt.sub_byte:
        t = pack_nibbles(t)
    t = t.contiguous()
    return (t, scales) if fmt.is_quantized else t


def unpack_b_ref(bp: torch.Tensor, k: int, n: int, layout: str = "row",
                 fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """Tile-major stack -> natural [K, N] (``fmt`` needed for int4)."""
    if fmt is not None and fmt.sub_byte:
        bp = unpack_nibbles(bp)
    if layout == "col":
        bp = bp.transpose(2, 3)
    nb, kb, bk, bn = bp.shape
    return bp.permute(1, 2, 0, 3).reshape(kb * bk, nb * bn)[:k, :n]


def dequant_b_tiles_ref(bp: torch.Tensor, scales,
                        fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """Quantized tiles + scales -> float tiles: int4 widens first, then each
    tile ([Nb, Kb] scales) or tile column ([Nb]) is multiplied by its
    scalar. No-op without scales."""
    if fmt is not None and fmt.sub_byte:
        bp = unpack_nibbles(bp)
    if scales is None:
        return bp
    extra = bp.dim() - scales.dim()
    return bp.to(scales.dtype) * scales[(...,) + (None,) * extra]


def unpack_b_dequant_ref(bp, scales, k: int, n: int, layout: str = "row",
                         fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """Quantized tile-major stack -> natural dequantized [K, N]."""
    return unpack_b_ref(dequant_b_tiles_ref(bp, scales, fmt=fmt), k, n,
                        layout)


def fused_packed_acc_ref(a: torch.Tensor, bp: torch.Tensor, n: int,
                         layout_b: str = "row", bm: int = 8, b_scales=None,
                         fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """Natural-layout A [M, K] against packed B: the f32 accumulator [M, N]
    that ``gemm_packed_fused_a`` computes before its epilogue. A is read as
    a blocked view of its own layout; quantized tiles dequantize first."""
    m, k = a.shape
    bp = dequant_b_tiles_ref(bp, b_scales, fmt=fmt)
    if fmt is None:
        fmt = TileFormat.from_packed(bp, layout_b)
    nb, kb = bp.shape[:2]
    bk, bn = fmt.bk, fmt.bn
    assert -(-k // bk) == kb, (tuple(a.shape), tuple(bp.shape))
    ap = pad2d(a, bm, bk)
    mb = ap.shape[0] // bm
    a4 = ap.reshape(mb, bm, kb, bk)
    ein_b = "jkbc" if layout_b == "row" else "jkcb"
    acc = torch.einsum(f"iakb,{ein_b}->iajc", a4.to(torch.float32),
                       bp.to(torch.float32))
    return acc.reshape(mb * bm, nb * bn)[:m, :n]


# ---------------------------------------------------------------------------
# Grouped (batched-expert) oracles
# ---------------------------------------------------------------------------

def grouped_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """The grouped-GEMM oracle: ``out[e] = A[e] @ B[e]`` for a [E, M, K], b
    [E, K, N], summed in f32, then cast (default A's dtype)."""
    acc = torch.einsum("emk,ekn->emn", a.to(torch.float32),
                       b.to(torch.float32))
    return acc.to(out_dtype or a.dtype)


def grouped_silu_gate_ref(a: torch.Tensor, bg: torch.Tensor, bu: torch.Tensor,
                          out_dtype=None) -> torch.Tensor:
    """The MoE pair's oracle: ``silu(A @ Bg) * (A @ Bu)`` per expert, both
    products and the gate in f32, then cast (default A's dtype)."""
    a32 = a.to(torch.float32)
    gate = torch.einsum("emk,ekn->emn", a32, bg.to(torch.float32))
    up = torch.einsum("emk,ekn->emn", a32, bu.to(torch.float32))
    return (KERNEL_EPILOGUES["silu"](gate) * up).to(out_dtype or a.dtype)


def pack_b_grouped_ref(b: torch.Tensor, bk, bn: Optional[int] = None,
                       layout: str = "row"):
    """B[E, K, N] -> [E, Nb, Kb, bk, bn], every expert packed as
    :func:`pack_b_ref` packs a matrix. A quantized format returns
    ``(packed, scales)`` with per-expert scale grids [E, Nb, Kb] (or
    [E, Nb] for col scales)."""
    assert b.dim() == 3, tuple(b.shape)
    return pack_b_ref(b, bk, bn, layout)


def unpack_b_grouped_ref(bp: torch.Tensor, k: int, n: int,
                         layout: str = "row", scales=None,
                         fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """[E, Nb, Kb, t0, t1] (+ optional [E, Nb, Kb] / [E, Nb] scales) ->
    natural [E, K, N]; dequantized (float) when scales are given."""
    bp = dequant_b_tiles_ref(bp, scales, fmt=fmt)
    if layout == "col":
        bp = bp.transpose(3, 4)
    e, nb, kb, bk, bn = bp.shape
    return bp.permute(0, 2, 3, 1, 4).reshape(e, kb * bk, nb * bn)[:, :k, :n]


def grouped_fused_acc_ref(a: torch.Tensor, bp: torch.Tensor, n: int,
                          layout_b: str = "row", bm: int = 8, b_scales=None,
                          fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """Natural [E, M, K] A against the packed stack [E, Nb, Kb, t0, t1]:
    the f32 accumulator [E, M, n] of the grouped kernel before its
    epilogue. One expert at a time, so a full-width stack is never widened
    to f32 all at once."""
    return torch.stack([
        fused_packed_acc_ref(a[e], bp[e], n, layout_b=layout_b, bm=bm,
                             b_scales=None if b_scales is None else b_scales[e],
                             fmt=fmt)
        for e in range(a.shape[0])])


def ragged_row_mask(c: int, counts: torch.Tensor) -> torch.Tensor:
    """[..., S] counts -> [..., S, C] bool; True on the valid leading rows."""
    return torch.arange(c, device=counts.device) < counts[..., None]


def grouped_ragged_ref(a, b, counts, *, b2=None, bias=None, epilogue_fn=None,
                       out_dtype=None) -> torch.Tensor:
    """Oracle of the ragged grouped GEMM: the padded contraction with the
    tail rows zeroed on both sides. a [E, S, C, K]; b (and the silu-gate
    partner ``b2``) natural [E, K, N]; counts [E, S]."""
    c = a.shape[2]
    mask = ragged_row_mask(c, counts)[..., None]             # [E, S, C, 1]
    am = torch.where(mask, a, torch.zeros((), dtype=a.dtype)).to(torch.float32)
    acc = torch.einsum("esck,ekn->escn", am, b.to(torch.float32))
    if bias is not None:
        acc = acc + bias.to(torch.float32)[:, None, None, :]
    if b2 is not None:
        out = KERNEL_EPILOGUES["silu"](acc) * torch.einsum(
            "esck,ekn->escn", am, b2.to(torch.float32))
    elif epilogue_fn is not None:
        out = epilogue_fn(acc)
    else:
        out = acc
    out = torch.where(mask, out, torch.zeros((), dtype=out.dtype))
    return out.to(out_dtype or a.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """[len(q_pos), len(k_pos)] bool: which keys each query sees (causal:
    ``q_pos >= k_pos``; window: ``q_pos - k_pos < window``, also without
    causal)."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None):
    """Softmax attention oracle. q:[B,Sq,H,D] k/v:[B,Skv,Hkv,D] (GQA via
    repeat), f32 scores and weights, output in q's dtype.

    ``window``: sliding-window size (tokens attend to the previous ``window``
    positions inclusive of self). Masked logits are ``-inf``, so a row that
    sees no key is NaN, as in the reference.
    """
    _, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if h != hkv:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)  # right-aligned
    mask = attention_mask(q_pos, torch.arange(skv, device=q.device),
                          causal=causal, window=window)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)
