"""K5 — per-call tile-major packing: ``pack_a``, ``pack_b`` and
``pack_b_grouped``. The CUDA kernel is ``csrc/pack.cu``; the plain torch
versions are the packers of ``kernels.ref`` (:func:`pack_a_plain`,
:func:`pack_b_plain`, :func:`pack_b_grouped_plain`).

A quantized format quantizes first, in plain torch as the reference does
(absmax per tile or per column of tiles, round half to even, clip), and the
kernel then copies the int8 values tile-major, nibble-packing int4 in its
store. Buffers and scale grids are byte-identical to the reference's.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.tile_format import (TileFormat, as_tile_format, cdiv,
                                          quantize_tiles)
from repro_torch.kernels import build
from repro_torch.kernels.ref import pack_a_ref, pack_b_grouped_ref, pack_b_ref

pack_a_plain = pack_a_ref
pack_b_plain = pack_b_ref
pack_b_grouped_plain = pack_b_grouped_ref

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,        # src, bytes, E, R
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,               # C, se, sr
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # sc, b0, b1, col_order
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,     # transpose, nibble, out, stream
]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("pack").pack_tiles_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _device_check(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu; got {x.device}")
    return True


def _launch(x3: torch.Tensor, b0: int, b1: int, *, col_order: bool,
            transpose: bool, nibble: bool, wrapper) -> torch.Tensor:
    """Launch the kernel on E matrices ``x3`` [E, R, C] (any strides):
    returns the contiguous [E, G_outer, G_inner, t0, t1] buffer. A launch
    adds one to ``wrapper.launches``; an empty buffer launches nothing."""
    e, r, c = x3.shape
    gr, gc = cdiv(r, b0), cdiv(c, b1)
    t0, t1 = (b1, b0) if transpose else (b0, b1)
    if nibble and (x3.dtype != torch.int8 or t1 % 2):
        raise ValueError(f"nibble packing takes int8 values and an even "
                         f"trailing tile dim; got {x3.dtype}, tile {t0, t1}")
    out = torch.empty((e,) + ((gc, gr) if col_order else (gr, gc))
                      + (t0, t1 // 2 if nibble else t1),
                      dtype=x3.dtype, device=x3.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = _kernel()(x3.data_ptr(), x3.element_size(), e, r, c,
                       *x3.stride(), b0, b1, int(col_order), int(transpose),
                       int(nibble), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def quantize_natural(b: torch.Tensor, fmt: TileFormat):
    """Float B [..., K, N] -> (int8 values in B's natural layout, zero-padded
    to whole tiles; scales [..., Nb, Kb] or [..., Nb]): the scale contract
    of ``quantize_tiles``, with the values put back in place so that the
    kernel's tile-major copy stays the one packing path (int4 values stay
    unpacked here; the kernel nibble-packs them)."""
    if not b.is_floating_point():
        raise ValueError(f"quantized packing consumes float weights; got "
                         f"{b.dtype}")
    lead, (k, n) = b.shape[:-2], b.shape[-2:]
    b = F.pad(b, (0, (-n) % fmt.bn, 0, (-k) % fmt.bk))
    kb, nb = b.shape[-2] // fmt.bk, b.shape[-1] // fmt.bn
    d = len(lead)
    tiles = b.reshape(*lead, kb, fmt.bk, nb, fmt.bn).permute(
        *range(d), d + 2, d, d + 1, d + 3)                   # [..., Nb, Kb, bk, bn]
    q, scales = quantize_tiles(tiles, fmt)
    q_nat = q.permute(*range(d), d + 1, d + 2, d, d + 3).reshape(b.shape)
    return q_nat, scales


def _pack_b_cuda(b3: torch.Tensor, fmt: TileFormat, wrapper):
    """[E, K, N] on the card -> (packed [E, Nb, Kb, t0, t1], scales)."""
    scales = None
    if fmt.is_quantized:
        b3, scales = quantize_natural(b3, fmt)
    packed = _launch(b3, fmt.bk, fmt.bn, col_order=True,
                     transpose=fmt.layout == "col", nibble=fmt.sub_byte,
                     wrapper=wrapper)
    return packed, scales


def pack_a(a: torch.Tensor, bm: int, bk: int,
           layout: str = "row") -> torch.Tensor:
    """A[M, K] -> [Mb, Kb, bm, bk] ("row") or [Mb, Kb, bk, bm] ("col"), tiles
    in row-of-tiles order, zero-filled past M and K."""
    if layout not in ("row", "col"):
        raise ValueError(f"bad layout {layout!r}")
    if not _device_check(a, "pack_a"):
        return pack_a_plain(a, bm, bk, layout)
    return _launch(a[None], bm, bk, col_order=False,
                   transpose=layout == "col", nibble=False, wrapper=pack_a)[0]


def pack_b(b: torch.Tensor, bk, bn: Optional[int] = None,
           layout: str = "row"):
    """B[K, N] -> [Nb, Kb, bk, bn] ("row") or [Nb, Kb, bn, bk] ("col"), tiles
    in column-of-tiles order, zero-filled past K and N. ``bk`` may be a
    :class:`TileFormat`; a quantized format returns ``(packed, scales)``."""
    fmt = as_tile_format(bk, bn, layout=layout, dtype=b.dtype)
    if b.dim() != 2:
        raise ValueError(f"pack_b takes B [K, N]; got {tuple(b.shape)}")
    if not _device_check(b, "pack_b"):
        return pack_b_plain(b, fmt)
    packed, scales = _pack_b_cuda(b[None], fmt, pack_b)
    return (packed[0], scales[0]) if fmt.is_quantized else packed[0]


def pack_b_grouped(b: torch.Tensor, bk, bn: Optional[int] = None,
                   layout: str = "row"):
    """B[E, K, N] -> [E, Nb, Kb, bk, bn] ("row") / [E, Nb, Kb, bn, bk]
    ("col"), every expert packed as :func:`pack_b` packs a matrix, in one
    launch. A quantized format returns ``(packed, scales)`` with per-expert
    grids [E, Nb, Kb] (or [E, Nb])."""
    fmt = as_tile_format(bk, bn, layout=layout, dtype=b.dtype)
    if b.dim() != 3:
        raise ValueError(f"pack_b_grouped takes B [E, K, N]; got "
                         f"{tuple(b.shape)}")
    if not _device_check(b, "pack_b_grouped"):
        return pack_b_grouped_plain(b, fmt)
    packed, scales = _pack_b_cuda(b, fmt, pack_b_grouped)
    return (packed, scales) if fmt.is_quantized else packed


pack_a.launches = 0
pack_b.launches = 0
pack_b_grouped.launches = 0
