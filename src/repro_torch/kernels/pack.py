"""K5 — per-call tile-major packing: ``pack_a``, ``pack_b`` and
``pack_b_grouped``. The CUDA kernel is ``csrc/pack.cu``; the plain torch
versions are the packers of ``kernels.ref`` (:func:`pack_a_plain`,
:func:`pack_b_plain`, :func:`pack_b_grouped_plain`).

A quantized format quantizes first, in plain torch as the reference does
(absmax per tile or per column of tiles, round half to even, clip), and the
kernel then copies the int8 values tile-major, nibble-packing int4 in its
store. Buffers and scale grids are byte-identical to the reference's.

:func:`pack_body` picks the kernel's body for each call: ``tma_copy`` (TMA
loads each tile and one bulk copy stores it; no thread touches an element)
where the stored tile is the source's box as it lies, ``tma_stage`` (the
same ring with a pass in shared memory that transposes and / or
nibble-packs) where it is not, and ``general`` (one thread an element,
any strides) for what TMA cannot read (:func:`pack_plan`). The
``.variants`` of each wrapper count its launches by body.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback. Each packer
opens with the ``pack`` fault site (``repro_torch.testing.faults``), as the
reference's do, so that a guarded contraction can degrade past it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.tile_format import (TileFormat, as_tile_format, cdiv,
                                          quantize_tiles)
from repro_torch.kernels import build, counts_launches
from repro_torch.kernels.ref import pack_a_ref, pack_b_grouped_ref, pack_b_ref
from repro_torch.testing import faults

pack_a_plain = pack_a_ref
pack_b_plain = pack_b_ref
pack_b_grouped_plain = pack_b_grouped_ref

# K5's bodies by name (the ``.variants`` keys) and their codes in the C
# entry point (enum Body of csrc/pack.cu).
PACK_BODIES = ("tma_copy", "tma_stage", "general")
BODY_CODES = {"general": 0, "tma_copy": 1, "tma_stage": 2}
TMA_BOX_MAX = 256      # elements of one TMA box dimension
CHUNK_BYTES = 16384    # one stage buffer of the ring (a 128 x 64 bf16 tile)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,        # src, bytes, E, R
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,               # C, se, sr
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,      # sc, b0, b1, col_order
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                         # transpose, nibble, body
    ctypes.c_void_p, ctypes.c_void_p,                                 # out, stream
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


def pack_strides(x3: torch.Tensor) -> tuple:
    """(se, sr, sc): the element strides of E matrices ``x3`` [E, R, C] as
    the kernel takes them. A dim of extent 1 is never stepped, so torch
    leaves its stride free; it is replaced here (as
    ``gemm_tiled.tiled_strides`` does) so that a [K, 1] column or a [1, N]
    row keeps the layout it has: a column whose row stride is 1 is
    R-contiguous, with a column stride of R rounded up to 16 bytes, else
    C-contiguous (likewise a row the other way round; a 1 x 1 matrix is
    C-contiguous), and a stack of one matrix steps by the matrix's span."""
    e, r, c = x3.shape
    se, sr, sc = x3.stride()
    per16 = max(1, 16 // x3.element_size())

    def row(extent):
        return cdiv(extent, per16) * per16
    if r == 1 and c == 1:
        sr, sc = row(1), 1
    elif c == 1:
        sc = row(r) if sr == 1 else 1
    elif r == 1:
        sr = row(c) if sc == 1 else 1
    if e == 1:
        se = max(r * sr, c * sc)
    return se, sr, sc


class PackPlan(NamedTuple):
    """How the TMA bodies walk a call (mirrors ``tma_plan`` of pack.cu).

    The source map is 3-D over X as it lies: its unit-stride axis ``unit``
    ("c" or "r", u below) first, then the other matrix axis (v), then E. A
    chunk is a slab of ``chunk_rows`` consecutive rows of the stored tile,
    ``chunks`` a tile (1 unless the tile overfills a CHUNK_BYTES stage);
    its box is ``box`` = (extent along u, extent along v), and it stores
    ``chunk_bytes`` contiguous bytes. ``transpose_pass``: the stored tile's
    trailing axis is v, so the stage pass transposes the box."""
    unit: str
    transpose_pass: bool
    chunk_rows: int
    chunks: int
    box: tuple
    chunk_bytes: int


def pack_plan(x3: torch.Tensor, b0: int, b1: int, transpose: bool,
              nibble: bool) -> Optional[PackPlan]:
    """The TMA bodies' plan for packing ``x3`` [E, R, C] into [b0, b1] tiles
    (stored [b1, b0] when ``transpose``; int4 nibble-packed along the stored
    trailing axis when ``nibble``), or None when TMA cannot read the call
    as it lies. TMA needs (strides after :func:`pack_strides`):

    * 1-, 2- or 4-byte elements (TMA's UINT8 / UINT16 / UINT32: raw bits);
    * a 16-byte aligned base;
    * exactly one unit stride, on R or on C (u), the other matrix stride
      (v) at least u's extent and both it and E's stride positive multiples
      of 16 bytes;
    * both tile dims at most 256 (a box dimension's limit; a larger tile is
      not split into several boxes: it takes ``general``);
    * a chunk whose box is at most CHUNK_BYTES, whose contiguous extent is
      a multiple of 16 bytes and whose stored bytes are a multiple of 16
      (the bulk store's unit); the slab is the whole tile, else its half,
      quarter, ... (the first that fits);
    * for a transpose, v's tile extent a multiple of the elements in a
      32-bit lane (the pass moves 4 x 4 bytes, 2 x 2 16-bit elements or
      single 32-bit ones)."""
    eb = x3.element_size()
    if eb not in (1, 2, 4) or x3.data_ptr() % 16 or max(b0, b1) > TMA_BOX_MAX:
        return None
    _, r, c = x3.shape
    se, sr, sc = pack_strides(x3)
    if (sr == 1) == (sc == 1):
        return None
    unit = "c" if sc == 1 else "r"
    bu, bv, ext_u, sv = (b1, b0, c, sr) if unit == "c" else (b0, b1, r, sc)
    if sv < ext_u or se <= 0 or (sv * eb) % 16 or (se * eb) % 16:
        return None
    tpass = (unit == "c") == bool(transpose)   # stored trailing axis is v
    t0, t1 = (bu, bv) if tpass else (bv, bu)   # the stored tile [t0, t1]
    row_bytes = (t1 // 2 if nibble else t1) * eb
    if tpass and bv % (4 // eb):
        return None
    q = 1
    while t0 % q == 0:
        h = t0 // q
        box = (h, bv) if tpass else (bu, h)
        if ((box[0] * eb) % 16 == 0 and (h * row_bytes) % 16 == 0
                and box[0] * box[1] * eb <= CHUNK_BYTES):
            return PackPlan(unit, tpass, h, q, box, h * row_bytes)
        q *= 2
    return None


def pack_tma_aligned(x3: torch.Tensor, b0: int, b1: int, transpose: bool,
                     nibble: bool) -> bool:
    """Whether the TMA bodies can take the call (:func:`pack_plan`)."""
    return pack_plan(x3, b0, b1, transpose, nibble) is not None


def pack_body(x3: torch.Tensor, b0: int, b1: int, transpose: bool,
              nibble: bool) -> str:
    """K5's body for the call: ``general`` unless :func:`pack_tma_aligned`;
    then ``tma_copy`` where the stored tile's trailing axis is X's unit
    stride axis and nothing is nibble-packed (the row layout of a row-major
    X: every served per-call pack and the projections at load; the col
    layout of a transposed view), else ``tma_stage`` (a transpose — the
    col layout of a row-major X, the row layout of ``table.t()`` as the LM
    heads are packed at load — a nibble packing, or both)."""
    plan = pack_plan(x3, b0, b1, transpose, nibble)
    if plan is None:
        return "general"
    return "tma_stage" if plan.transpose_pass or nibble else "tma_copy"


def launch_args(x3: torch.Tensor, b0: int, b1: int, *, col_order: bool,
                transpose: bool, nibble: bool, body: str, out: torch.Tensor,
                stream) -> tuple:
    """The C entry point's arguments for packing ``x3`` into ``out`` on
    ``body`` (the entry point refuses a body that cannot take the call)."""
    e, r, c = x3.shape
    return (x3.data_ptr(), x3.element_size(), e, r, c, *pack_strides(x3), b0,
            b1, int(col_order), int(transpose), int(nibble), BODY_CODES[body],
            out.data_ptr(), stream)


def _launch(x3: torch.Tensor, b0: int, b1: int, *, col_order: bool,
            transpose: bool, nibble: bool, wrapper) -> torch.Tensor:
    """Launch the kernel on E matrices ``x3`` [E, R, C] (any strides):
    returns the contiguous [E, G_outer, G_inner, t0, t1] buffer. A launch
    adds one to ``wrapper.launches`` and to ``wrapper.variants`` of the
    body :func:`pack_body` names; an empty buffer launches nothing."""
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
    body = pack_body(x3, b0, b1, transpose, nibble)
    # Only a stubbed kernel ever sees a CPU tensor (the launch-count tests).
    on_card = x3.is_cuda
    with torch.cuda.device(x3.device) if on_card else contextlib.nullcontext():
        stream = torch.cuda.current_stream(x3.device).cuda_stream if on_card else None
        rc = _kernel()(*launch_args(x3, b0, b1, col_order=col_order,
                                    transpose=transpose, nibble=nibble,
                                    body=body, out=out, stream=stream))
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed ({body}): CUDA "
                           f"error {rc}")
    wrapper.launches += 1
    wrapper.variants[body] += 1
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
    faults.maybe_fail("pack")
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
    faults.maybe_fail("pack")
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
    faults.maybe_fail("pack")
    fmt = as_tile_format(bk, bn, layout=layout, dtype=b.dtype)
    if b.dim() != 3:
        raise ValueError(f"pack_b_grouped takes B [E, K, N]; got "
                         f"{tuple(b.shape)}")
    if not _device_check(b, "pack_b_grouped"):
        return pack_b_grouped_plain(b, fmt)
    packed, scales = _pack_b_cuda(b, fmt, pack_b_grouped)
    return (packed, scales) if fmt.is_quantized else packed


for _fn in (pack_a, pack_b, pack_b_grouped):
    counts_launches(_fn, PACK_BODIES)
