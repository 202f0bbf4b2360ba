"""TileFormat — the packed-B tile format as one descriptor (torch port).

The B operand is stored tile-major as ``[Nb, Kb, t0, t1]``: ``[bk, bn]``
tiles for ``layout="row"``, ``[bn, bk]`` for ``"col"``, zero-filled past the
ragged K/N edges. A :class:`ScaleSpec` marks the format quantized: integer
tile elements plus a dense f32 scale grid, ``[Nb, Kb]`` (one scale per tile,
applied to each K-step's partial product) or ``[Nb]`` (``"col"``: one scale
per column of tiles, applied once to the finished accumulator).

``dtype="int4"`` nibble-packs two values a byte along the trailing tile
axis: element ``2i`` in the low nibble, ``2i+1`` in the high nibble of byte
``i``. The buffer is int8 with a halved trailing dim. Buffers are
byte-identical to the JAX reference's (``repro.core.tile_format``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.dtypes import dtype_name, info, is_integer, torch_dtype


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack an int stack along its trailing axis (two values a byte):
    element ``2i`` in the low nibble, ``2i+1`` in the high nibble."""
    if q.shape[-1] % 2:
        raise ValueError(f"nibble pack needs an even trailing dim, got "
                         f"{tuple(q.shape)}")
    q = q.to(torch.int8)
    lo, hi = q[..., 0::2], q[..., 1::2]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.int8)


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Invert :func:`pack_nibbles`: sign-extend both nibbles (``-8`` reads
    back); the trailing dim doubles."""
    p = p.to(torch.int8)
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


@dataclasses.dataclass(frozen=True)
class ScaleSpec:
    """Dequantization scale of a quantized format: ``"tile"`` ([Nb, Kb]) or
    ``"col"`` ([Nb], hoisted into the store epilogue)."""

    dtype: str = "float32"
    granularity: str = "tile"

    def __post_init__(self):
        if self.granularity not in ("tile", "col"):
            raise ValueError(
                f"unsupported scale granularity {self.granularity!r} "
                "(defined: per-(Kb,Nb)-'tile', per-Nb-'col')")

    @property
    def itemsize(self) -> int:
        return int(info(self.dtype).itemsize)


@dataclasses.dataclass(frozen=True)
class TileFormat:
    """Descriptor of one tile-major packed-B buffer ``[Nb, Kb, t0, t1]``."""

    bk: int
    bn: int
    layout: str = "row"
    dtype: str = "float32"
    scale: Optional[ScaleSpec] = None

    def __post_init__(self):
        if self.layout not in ("row", "col"):
            raise ValueError(f"bad layout {self.layout!r}")
        if self.scale is not None and not is_integer(self.dtype):
            raise ValueError(
                f"per-tile scales go with integer tile elements; got "
                f"dtype={self.dtype!r}")
        if self.sub_byte and self.tile_shape[-1] % 2:
            raise ValueError(
                f"int4 tiles nibble-pack pairs along the trailing tile dim, "
                f"which must be even; got tile {self.tile_shape}")

    @property
    def tile_shape(self) -> Tuple[int, int]:
        """Shape of one logical tile: [bk, bn] ("row") / [bn, bk] ("col")."""
        return (self.bn, self.bk) if self.layout == "col" else (self.bk,
                                                                self.bn)

    @property
    def sub_byte(self) -> bool:
        return self.dtype == "int4"

    @property
    def storage_dtype(self) -> str:
        return "int8" if self.sub_byte else self.dtype

    @property
    def storage_tile_shape(self) -> Tuple[int, int]:
        """One stored tile: the trailing dim halves for int4."""
        t0, t1 = self.tile_shape
        return (t0, t1 // 2) if self.sub_byte else (t0, t1)

    def grid(self, k: int, n: int) -> Tuple[int, int]:
        """(Nb, Kb) tile grid covering a [K, N] operand."""
        return cdiv(n, self.bn), cdiv(k, self.bk)

    def packed_shape(self, k: int, n: int) -> Tuple[int, int, int, int]:
        return self.grid(k, n) + self.storage_tile_shape

    @property
    def itemsize(self) -> float:
        return info(self.dtype).itemsize

    @property
    def is_quantized(self) -> bool:
        return self.scale is not None

    @property
    def col_scaled(self) -> bool:
        return self.scale is not None and self.scale.granularity == "col"

    def tile_bytes(self) -> int:
        """Bytes of one stored tile, with its per-tile scale."""
        b = self.bk * self.bn * self.itemsize
        if self.scale is not None and self.scale.granularity == "tile":
            b += self.scale.itemsize
        return math.ceil(b)

    def packed_bytes(self, k: int, n: int) -> int:
        """Bytes of the whole packed stack (+ scales) for a [K, N] operand."""
        nb, kb = self.grid(k, n)
        total = nb * kb * self.tile_bytes()
        if self.col_scaled:
            total += nb * self.scale.itemsize
        return total

    @classmethod
    def from_packed(cls, packed: torch.Tensor, layout: str = "row",
                    has_scales: bool = False) -> "TileFormat":
        """Recover the format of a self-describing buffer. Cannot see int4
        (physically int8 with a halved trailing dim): pass the format."""
        t0, t1 = packed.shape[-2:]
        bk, bn = (t1, t0) if layout == "col" else (t0, t1)
        return cls(bk=int(bk), bn=int(bn), layout=layout,
                   dtype=dtype_name(packed.dtype),
                   scale=ScaleSpec() if has_scales else None)


def is_dequant_pair(compute_dtype, b_dtype) -> bool:
    """A format is dequant-in-epilogue exactly when B's element dtype is a
    narrow integer under a non-integer compute dtype."""
    if b_dtype is None:
        return False
    return is_integer(b_dtype) and not is_integer(compute_dtype)


def normalize_packed(out, fmt: TileFormat):
    """A packer's return as ``(packed, scales-or-None)``."""
    return out if fmt.is_quantized else (out, None)


def quantize_tiles(t: torch.Tensor, fmt: TileFormat):
    """Row-layout float tile stack [..., Nb, Kb, bk, bn] -> (int tiles,
    scales): ``scale = absmax/qmax`` (qmax 127 for int8, 7 for int4; 1.0 for
    an all-zero group), values rounded half-to-even and then clipped to
    [-qmax, qmax]. int4 comes back unpacked, as int8 values."""
    qmax = 7.0 if fmt.sub_byte else 127.0
    if fmt.col_scaled:
        absmax = t.abs().amax(dim=(-3, -2, -1))
        bcast = (..., None, None, None)
    else:
        absmax = t.abs().amax(dim=(-2, -1))
        bcast = (..., None, None)
    sdt = torch_dtype(fmt.scale.dtype)
    scales = torch.where(absmax > 0, absmax / qmax,
                         torch.ones_like(absmax)).to(sdt)
    # torch.round is half-to-even, as jnp.round.
    q = torch.round(t / scales[bcast]).clamp(-qmax, qmax)
    return q.to(torch_dtype(fmt.storage_dtype)), scales


def as_tile_format(fmt, bn: Optional[int] = None, *, layout: str = "row",
                   dtype=None) -> TileFormat:
    """A :class:`TileFormat`, or legacy ``(bk, bn, layout)`` ints, as a
    format."""
    if isinstance(fmt, TileFormat):
        return fmt
    if bn is None:
        raise TypeError("pack needs a TileFormat or explicit (bk, bn) ints")
    return TileFormat(bk=int(fmt), bn=int(bn), layout=layout,
                      dtype=dtype_name(dtype or "float32"))
