"""Grouped (batched-expert) GEMM over load-time-packed expert stacks — the
MoE layer's expert contractions. The CUDA kernel is
``csrc/gemm_grouped_packed.cu``; one entry point serves both wrappers:

  * :func:`gemm_grouped_packed_ragged` (K2): A [E, S, C, K] in S capacity
    segments of C rows per expert, ``counts`` [E, S] valid leading rows per
    segment (clamped to [0, C]); rows at or past the count are 0 in the
    output, and a block of the kernel whose rows are all padding stores
    zeros without loading anything.
  * :func:`gemm_grouped_packed` (K3): A [E, M, K], every row live — the
    same kernel with no counts.

Both take ``epilogue="silu_gate"`` with a partner stack ``b2_packed``: the
MoE gate/up pair ``silu(A @ Bg) * (A @ Bu)`` with two accumulators over one
read of A. The plain torch versions sit beside them
(:func:`gemm_grouped_packed_ragged_plain`, :func:`gemm_grouped_packed_plain`),
built on the grouped oracles of ``kernels.ref``. :func:`grouped_body`
picks the kernel's body per call, and each wrapper's ``.variants`` counts
its launches by body.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.dtypes import dtype_name
from repro_torch.core.epilogue import as_epilogue_spec
from repro_torch.core.tile_format import TileFormat
from repro_torch.kernels import build, counts_launches
from repro_torch.kernels.common import (EPILOGUE_CODES, acc_dtype_for, cdiv,
                                        kernel_epilogue_name)
from repro_torch.kernels.gemm_packed import (_A_DTYPES, _B_DTYPES, _BM_CHOICES,
                                             _DT, _OUT_DTYPES, FMA,
                                             SPLIT_BODIES, TC_BOX, _pick_bn,
                                             pick_variant, tc_stream_split)
from repro_torch.kernels.ref import (grouped_fused_acc_ref, ragged_row_mask,
                                     unpack_b_grouped_ref)

MAX_SEGMENTS = 65535  # the kernel's segment grid axis (gridDim.z)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,  # a, dt, sa_e, sa_s
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,          # lda, E, S, C
    ctypes.c_int, ctypes.c_void_p,                                        # K, counts
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # b, b2, dt, col
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,               # Nb, Kb, bk, bn
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,      # scales, scales2, mode, bias
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,            # out, dt, N, act
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,               # BM, BN, KC, int_acc
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,            # body, splits, kchunk, ws
    ctypes.c_void_p,                                                      # stream
]

# The bodies by name (the ``.variants`` keys): the TMA bodies (codes 4 and
# 3 of the CUDA source), the quantized TMA bodies (5 and 6), the first
# port's mma.sync body (1 decode, 2 prefill tiles, by pick_variant) and its
# scalar-FMA body (0).
GROUPED_BODIES = ("tc_stream", "wgmma", "tc_stream_q", "wgmma_q", "mma_sync",
                  "fma")
_BODY_CODE = {"fma": 0, "wgmma": 3, "tc_stream": 4, "tc_stream_q": 5,
              "wgmma_q": 6}


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("gemm_grouped_packed")
    fn = lib.gemm_grouped_packed_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _resolve(b_packed, layout_b, b_scales, b2_packed, b2_scales, epilogue,
             b_format):
    """(format, has_gate), after checking the silu-gate operands."""
    has_gate = epilogue == "silu_gate"
    if has_gate != (b2_packed is not None):
        raise ValueError("epilogue='silu_gate' requires b2_packed (and only "
                         "silu_gate takes it)")
    if has_gate and (b_scales is None) != (b2_scales is None):
        raise ValueError("quantized silu_gate needs BOTH scale grids")
    fmt = b_format if b_format is not None else TileFormat.from_packed(
        b_packed, layout_b, has_scales=b_scales is not None)
    return fmt, has_gate


def unpack_b_grouped(b_packed: torch.Tensor, k: int, n: int,
                     layout_b: str = "row",
                     scales: Optional[torch.Tensor] = None,
                     fmt: Optional[TileFormat] = None) -> torch.Tensor:
    """Tile-major [E, Nb, Kb, t0, t1] -> natural [E, K, N], one copy.
    ``scales`` ([E, Nb, Kb] per tile, [E, Nb] per column) dequantizes each
    tile first, so the result is float; ``fmt`` is needed for nibble-packed
    int4 stacks, which widen to int8 before anything else."""
    return unpack_b_grouped_ref(b_packed, k, n, layout_b, scales=scales,
                                fmt=fmt)


def gemm_grouped_packed_plain(a: torch.Tensor, b_packed: torch.Tensor, n: int,
                              *, b2_packed: Optional[torch.Tensor] = None,
                              bm: int = 64, layout_b: str = "row",
                              b_scales: Optional[torch.Tensor] = None,
                              b2_scales: Optional[torch.Tensor] = None,
                              out_dtype=None, epilogue: str = "none",
                              bias: Optional[torch.Tensor] = None,
                              b_format: Optional[TileFormat] = None
                              ) -> torch.Tensor:
    """The plain torch version of K3: ``grouped_fused_acc_ref`` per stream
    (f32 accumulators, quantized tiles dequantized first), then the
    epilogue chain: bias [E, n], then the activation, or ``silu(acc) *
    acc2`` for the gate pair."""
    fmt, has_gate = _resolve(b_packed, layout_b, b_scales, b2_packed,
                             b2_scales, epilogue, b_format)
    acc = grouped_fused_acc_ref(a, b_packed, n, layout_b=fmt.layout, bm=bm,
                                b_scales=b_scales, fmt=fmt)
    acc2 = (grouped_fused_acc_ref(a, b2_packed, n, layout_b=fmt.layout, bm=bm,
                                  b_scales=b2_scales, fmt=fmt)
            if has_gate else None)
    epi = as_epilogue_spec(epilogue).with_bias(bias is not None)
    out = epi.apply(acc, bias=None if bias is None else bias[:, None, :],
                    gate=acc2)
    return out.to(out_dtype or a.dtype)


def gemm_grouped_packed_ragged_plain(a: torch.Tensor, b_packed: torch.Tensor,
                                     n: int, counts: torch.Tensor,
                                     **kw) -> torch.Tensor:
    """The plain torch version of K2: K3's plain version on A with the rows
    at or past the (clamped) counts zeroed, and the same rows zeroed in the
    output [E, S, C, n]. It is the counterpart of the reference's
    ``gemm_grouped_packed_ragged_jnp``, with the same arguments."""
    e, s, c, k = a.shape
    if tuple(counts.shape) != (e, s):
        raise ValueError(f"counts must be [E, S]={e, s}; got "
                         f"{tuple(counts.shape)}")
    mask = ragged_row_mask(c, counts.clamp(0, c))[..., None]
    am = torch.where(mask, a, torch.zeros((), dtype=a.dtype, device=a.device))
    out = gemm_grouped_packed_plain(am.reshape(e, s * c, k), b_packed, n, **kw)
    out = out.reshape(e, s, c, n)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def _check_scales(scales, fmt, e, nb, kb, name):
    want = (e, nb) if fmt.col_scaled else (e, nb, kb)
    if (tuple(scales.shape) != want or scales.dtype != torch.float32
            or not scales.is_contiguous()):
        raise ValueError(f"{name} must be contiguous f32 {want}; got "
                         f"{tuple(scales.shape)} {scales.dtype}")


def a_strides(a: torch.Tensor) -> tuple:
    """A's element strides (sa_e, sa_s, lda) as the kernel takes them. A dim
    of extent 1 is never stepped, so its stride is replaced by the span of
    the dims inside it (K rounded up to 8 for the rows): torch leaves such
    strides free, and the TMA bodies need each one a multiple of 16 bytes."""
    e, s, c, k = a.shape
    lda = a.stride(2) if c > 1 else cdiv(k, 8) * 8
    sa_s = a.stride(1) if s > 1 else lda * c
    sa_e = a.stride(0) if e > 1 else sa_s * s
    return sa_e, sa_s, lda


def grouped_tma_aligned(a: torch.Tensor, b_packed: torch.Tensor,
                        b2_packed: Optional[torch.Tensor] = None) -> bool:
    """Whether A [E, S, C, K] and the packed stacks can be read through TMA
    tensor maps: 16-byte aligned bases, each of A's strides (:func:`a_strides`)
    a positive multiple of 16 bytes, and rows that do not overlap (lda >= K).
    The strides may come in any order (a permuted A)."""
    item, strides = a.element_size(), a_strides(a)
    bases = [a, b_packed] + ([b2_packed] if b2_packed is not None else [])
    return (all(t.data_ptr() % 16 == 0 for t in bases)
            and all(st > 0 and (st * item) % 16 == 0 for st in strides)
            and strides[2] >= a.shape[3])


def grouped_body(a_dtype: torch.dtype, fmt: TileFormat, c: int, *,
                 scaled: bool, tma_ok: bool) -> str:
    """K2 / K3's body for A of ``a_dtype`` in segments of ``c`` rows (the
    envelope C; the counts stay on the device) against packed tiles of
    ``fmt`` (``scaled``: the tiles carry scales; ``tma_ok``: what
    :func:`grouped_tma_aligned` says of the operands):

    * bf16 / f16 A against unscaled tiles of the same type with bn 64 and
      bk a multiple of 64, on aligned operands: ``tc_stream`` up to 16
      rows, ``wgmma`` above;
    * bf16 / f16 A against int8 / int4 tiles (tile, col or no scales) of
      the same geometry on aligned operands: ``tc_stream_q`` up to 16 rows,
      ``wgmma_q`` above;
    * every other pair keeps PR 12's bodies as :func:`pick_variant` picks
      them: ``mma_sync`` (bf16 / f16 A against float tiles of other
      geometries or alignments, or int8 / int4 tiles of other geometries
      or under a misaligned A) and ``fma`` (f32 A, int8 A with i32
      accumulators, mixed float types).
    """
    a_dt = dtype_name(a_dtype)
    tma_tiles = tma_ok and fmt.bn == TC_BOX and fmt.bk % TC_BOX == 0
    if a_dt in ("bfloat16", "float16") and tma_tiles:
        if not scaled and fmt.dtype == a_dt:
            return "tc_stream" if c <= 16 else "wgmma"
        if fmt.dtype in ("int8", "int4"):
            return "tc_stream_q" if c <= 16 else "wgmma_q"
    return "fma" if pick_variant(a_dtype, fmt, c) == FMA else "mma_sync"


def launch_args(a, b_packed, n, counts, *, b2_packed, bm, b_scales,
                b2_scales, out, epilogue, bias, fmt, stream) -> tuple:
    """Check the operands against what the kernel takes and build the C
    entry point's argument tuple (raises ``ValueError`` on anything else).
    ``a`` is [E, S, C, K]; ``counts`` [E, S] int32 or None (every row).
    Returns ``(args, keep, body)``: ``keep`` holds the converted bias and
    tc_stream's split-K workspace, which must outlive the launch."""
    if a.dim() != 4:
        raise ValueError(f"A must be [E, S, C, K]; got {tuple(a.shape)}")
    e, s, c, k = a.shape
    a_dt, b_dt = dtype_name(a.dtype), fmt.dtype
    int_acc = acc_dtype_for(a.dtype) == torch.int32
    has_gate = b2_packed is not None
    if a_dt not in _A_DTYPES:
        raise ValueError(f"kernel takes A in {_A_DTYPES}; got {a_dt}")
    if a.stride(3) != 1:
        raise ValueError("A must have unit column stride")
    if e * s > MAX_SEGMENTS:
        raise ValueError(f"E*S={e * s} segments exceed {MAX_SEGMENTS}")
    for name, bp in (("B", b_packed), ("B2", b2_packed)):
        if bp is None:
            continue
        if b_dt not in _B_DTYPES or dtype_name(bp.dtype) != fmt.storage_dtype:
            raise ValueError(f"packed {name} of dtype {bp.dtype} does not "
                             f"match format {fmt}")
        if not bp.is_contiguous() or bp.dim() != 5 or bp.shape[0] != e:
            raise ValueError(f"packed {name} must be a contiguous "
                             f"[E={e}, Nb, Kb, t0, t1] stack; got "
                             f"{tuple(bp.shape)}")
        if tuple(bp.shape[3:]) != fmt.storage_tile_shape:
            raise ValueError(f"packed {name} tiles {tuple(bp.shape[3:])} do "
                             f"not match format {fmt}")
    if has_gate and b2_packed.shape != b_packed.shape:
        raise ValueError(f"silu_gate pair shapes differ: "
                         f"{tuple(b_packed.shape)} vs {tuple(b2_packed.shape)}")
    nb, kb = b_packed.shape[1:3]
    if cdiv(k, fmt.bk) != kb or not (0 < n <= nb * fmt.bn):
        raise ValueError(f"A {tuple(a.shape)} / n={n} do not fit packed B "
                         f"{tuple(b_packed.shape)}")
    if fmt.bk % 16 or fmt.bn % 16:
        raise ValueError(f"kernel takes tiles in multiples of 16; got {fmt}")
    if bm not in _BM_CHOICES:
        raise ValueError(f"kernel m-block must be one of {_BM_CHOICES}; got {bm}")
    if int_acc and (b_scales is not None or fmt.dtype not in ("int8", "int4")):
        raise ValueError("int8 A takes unscaled int8/int4 B only")
    if dtype_name(out.dtype) not in _OUT_DTYPES:
        raise ValueError(f"kernel stores {_OUT_DTYPES}; got {out.dtype}")
    if not out.is_contiguous() or tuple(out.shape) != (e, s, c, n):
        raise ValueError(f"out must be a contiguous [{e}, {s}, {c}, {n}]; got "
                         f"{tuple(out.shape)}")
    scale_mode = 0
    if b_scales is not None:
        scale_mode = 2 if fmt.col_scaled else 1
        _check_scales(b_scales, fmt, e, nb, kb, "scales")
        if has_gate:
            _check_scales(b2_scales, fmt, e, nb, kb, "b2 scales")
    if counts is not None:
        if (tuple(counts.shape) != (e, s) or counts.dtype != torch.int32
                or not counts.is_contiguous()):
            raise ValueError(f"counts must be contiguous int32 [E, S]={e, s}; "
                             f"got {tuple(counts.shape)} {counts.dtype}")
    for t in (b_packed, b2_packed, b_scales, b2_scales, bias, counts, out):
        if t is not None and t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
    if bias is not None:
        if tuple(bias.shape) != (e, n):
            raise ValueError(f"bias must be [{e}, {n}]; got {tuple(bias.shape)}")
        bias = (bias.to(torch.int32) if int_acc else bias).to(torch.float32)
        bias = bias.contiguous()
    body = grouped_body(a.dtype, fmt, c, scaled=b_scales is not None,
                        tma_ok=grouped_tma_aligned(a, b_packed, b2_packed))
    ws, splits, chunk = None, 1, 0
    if body in SPLIT_BODIES:
        # The split depends on shapes only: the counts stay on the device.
        splits, chunk = tc_stream_split(kb, e * s * nb)
        if splits > 1:
            ws = torch.empty((splits, 2 if has_gate else 1, e * s * c, n),
                             dtype=torch.float32, device=a.device)
    code = (pick_variant(a.dtype, fmt, c) if body == "mma_sync"
            else _BODY_CODE[body])
    bn_chunk = _pick_bn(fmt.bn, e * s * cdiv(c, bm))
    kc = 32 if fmt.bk % 32 == 0 else 16
    act = EPILOGUE_CODES["silu" if has_gate else kernel_epilogue_name(epilogue)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (a.data_ptr(), _DT[a_dt], *a_strides(a), e, s, c, k, ptr(counts),
            b_packed.data_ptr(), ptr(b2_packed), _DT[b_dt],
            int(fmt.layout == "col"), nb, kb, fmt.bk, fmt.bn,
            ptr(b_scales), ptr(b2_scales if has_gate else None), scale_mode,
            ptr(bias), out.data_ptr(), _DT[dtype_name(out.dtype)], n, act,
            bm, bn_chunk, kc, int(int_acc), code, splits, chunk, ptr(ws),
            stream)
    return args, (bias, ws), body


def _launch(fn, a4, b_packed, n, counts, *, out_dtype, stream,
            **kw) -> torch.Tensor:
    """Allocate [E, S, C, n], launch the kernel on it on ``stream`` and
    count the launch on the wrapper ``fn`` by body. The output is
    ``torch.empty``: the kernel stores every element, zeros included."""
    e, s, c, _ = a4.shape
    out = torch.empty((e, s, c, n), dtype=out_dtype, device=a4.device)
    args, keep, body = launch_args(a4, b_packed, n, counts, out=out,
                                   stream=stream, **kw)
    rc = _kernel()(*args)
    del keep
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed ({body}): CUDA "
                           f"error {rc}")
    fn.launches += 1
    fn.variants[body] += 1
    return out


def _on_card(fn, a4, b_packed, n, counts, **kw) -> torch.Tensor:
    """The CUDA path of a wrapper: the kernel on ``a4``'s card and stream."""
    if a4.device.type != "cuda":
        raise ValueError(f"{fn.__name__} runs on cuda or cpu; got {a4.device}")
    with torch.cuda.device(a4.device):
        stream = torch.cuda.current_stream(a4.device).cuda_stream
        return _launch(fn, a4, b_packed, n, counts, stream=stream, **kw)


def gemm_grouped_packed_ragged(a: torch.Tensor, b_packed: torch.Tensor, n: int,
                               counts: torch.Tensor, *,
                               b2_packed: Optional[torch.Tensor] = None,
                               bm: int = 64, layout_b: str = "row",
                               b_scales: Optional[torch.Tensor] = None,
                               b2_scales: Optional[torch.Tensor] = None,
                               out_dtype=None, epilogue: str = "none",
                               bias: Optional[torch.Tensor] = None,
                               b_format: Optional[TileFormat] = None
                               ) -> torch.Tensor:
    """K2: ``out[e, s, r] = epi(A[e, s, r] @ deq(B[e]))`` for rows
    ``r < counts[e, s]`` (clamped to [0, C]), 0 past them; [E, S, C, n].

    ``a`` [E, S, C, K]; ``counts`` [E, S] int32; ``b_packed`` [E, Nb, Kb,
    t0, t1] from ``pack_b_grouped_ref``; ``b_scales`` [E, Nb, Kb] per tile
    or [E, Nb] per column; ``bias`` [E, n]; ``epilogue`` a kernel epilogue
    name, or ``"silu_gate"`` with ``b2_packed`` (and ``b2_scales``). On the
    CPU this is :func:`gemm_grouped_packed_ragged_plain`; on the card it
    launches the CUDA kernel on the body :func:`grouped_body` picks (``bm``
    is the fma body's m-block; the other bodies choose their own tiles).
    """
    kw = dict(b2_packed=b2_packed, bm=bm, b_scales=b_scales,
              b2_scales=b2_scales, epilogue=epilogue, bias=bias)
    if a.device.type == "cpu":
        return gemm_grouped_packed_ragged_plain(
            a, b_packed, n, counts, layout_b=layout_b, out_dtype=out_dtype,
            b_format=b_format, **kw)
    fmt, _ = _resolve(b_packed, layout_b, b_scales, b2_packed, b2_scales,
                      epilogue, b_format)
    return _on_card(gemm_grouped_packed_ragged, a, b_packed, n, counts,
                    out_dtype=out_dtype or a.dtype, fmt=fmt, **kw)


def gemm_grouped_packed(a: torch.Tensor, b_packed: torch.Tensor, n: int, *,
                        b2_packed: Optional[torch.Tensor] = None,
                        bm: int = 64, layout_b: str = "row",
                        b_scales: Optional[torch.Tensor] = None,
                        b2_scales: Optional[torch.Tensor] = None,
                        out_dtype=None, epilogue: str = "none",
                        bias: Optional[torch.Tensor] = None,
                        b_format: Optional[TileFormat] = None) -> torch.Tensor:
    """K3: ``out[e] = epi(A[e] @ deq(B[e]) + bias[e])`` for A [E, M, K],
    every row live; operands as in :func:`gemm_grouped_packed_ragged`. On
    the CPU this is :func:`gemm_grouped_packed_plain`; on the card the
    grouped kernel with no counts, on the body :func:`grouped_body` picks
    for C = M."""
    kw = dict(b2_packed=b2_packed, bm=bm, b_scales=b_scales,
              b2_scales=b2_scales, epilogue=epilogue, bias=bias)
    if a.device.type == "cpu":
        return gemm_grouped_packed_plain(
            a, b_packed, n, layout_b=layout_b, out_dtype=out_dtype,
            b_format=b_format, **kw)
    fmt, _ = _resolve(b_packed, layout_b, b_scales, b2_packed, b2_scales,
                      epilogue, b_format)
    return _on_card(gemm_grouped_packed, a[:, None], b_packed, n, None,
                    out_dtype=out_dtype or a.dtype, fmt=fmt, **kw)[:, 0]


for _fn in (gemm_grouped_packed_ragged, gemm_grouped_packed):
    counts_launches(_fn, GROUPED_BODIES)
