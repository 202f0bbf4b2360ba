"""Plain-torch oracles of the packed-B layer: the load-time packer and the
unpack / dequant / fused-A accumulation references the kernels are held
against. Buffers and scale grids are byte-identical to the JAX package's
``repro.kernels.ref`` for the same :class:`TileFormat`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.tile_format import (TileFormat, as_tile_format,
                                          pack_nibbles, quantize_tiles,
                                          unpack_nibbles)
from repro_torch.kernels.common import pad2d


def pack_b_ref(b: torch.Tensor, bk, bn: Optional[int] = None,
               layout: str = "row"):
    """Pack B[K,N] into [Nb, Kb, bk, bn] (row) / [Nb, Kb, bn, bk] (col),
    zero-filling the ragged edges. ``bk`` may be a :class:`TileFormat`. A
    quantized format returns ``(packed, scales)``; int4 tiles are
    nibble-packed along the trailing tile axis as the last step."""
    fmt = as_tile_format(bk, bn, layout=layout, dtype=b.dtype)
    b = pad2d(b, fmt.bk, fmt.bn)
    kb, nb = b.shape[0] // fmt.bk, b.shape[1] // fmt.bn
    t = b.reshape(kb, fmt.bk, nb, fmt.bn).permute(2, 0, 1, 3)
    scales = None
    if fmt.is_quantized:
        assert b.dtype.is_floating_point, (
            f"quantized packing consumes float weights; got {b.dtype}")
        t, scales = quantize_tiles(t, fmt)
    if fmt.layout == "col":
        t = t.transpose(2, 3)
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
