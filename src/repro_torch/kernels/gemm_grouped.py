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
built on the grouped oracles of ``kernels.ref``.

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
from repro_torch.kernels import build
from repro_torch.kernels.common import (EPILOGUE_CODES, acc_dtype_for, cdiv,
                                        kernel_epilogue_name)
from repro_torch.kernels.gemm_packed import (_A_DTYPES, _B_DTYPES, _BM_CHOICES,
                                             _DT, _OUT_DTYPES, _pick_bn,
                                             pick_variant)
from repro_torch.kernels.ref import grouped_fused_acc_ref, ragged_row_mask

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
    ctypes.c_int, ctypes.c_void_p,                                        # variant, stream
]


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
    output [E, S, C, n]."""
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


def launch_args(a, b_packed, n, counts, *, b2_packed, bm, b_scales,
                b2_scales, out, epilogue, bias, fmt, stream) -> tuple:
    """Check the operands against what the kernel takes and build the C
    entry point's argument tuple (raises ``ValueError`` on anything else).
    ``a`` is [E, S, C, K]; ``counts`` [E, S] int32 or None (every row)."""
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
    for t in (b_packed, b2_packed, b_scales, b2_scales, bias, counts):
        if t is not None and t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
    if bias is not None:
        if tuple(bias.shape) != (e, n):
            raise ValueError(f"bias must be [{e}, {n}]; got {tuple(bias.shape)}")
        bias = (bias.to(torch.int32) if int_acc else bias).to(torch.float32)
        bias = bias.contiguous()
    bn_chunk = _pick_bn(fmt.bn, e * s * cdiv(c, bm))
    kc = 32 if fmt.bk % 32 == 0 else 16
    # K1's rule on a segment's envelope C (the counts stay on the device):
    # 16-row decode blocks up to 16 rows, 32-row prefill blocks above.
    variant = pick_variant(a.dtype, fmt, c)
    act = EPILOGUE_CODES["silu" if has_gate else kernel_epilogue_name(epilogue)]

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (a.data_ptr(), _DT[a_dt], a.stride(0), a.stride(1), a.stride(2),
            e, s, c, k, ptr(counts),
            b_packed.data_ptr(), ptr(b2_packed), _DT[b_dt],
            int(fmt.layout == "col"), nb, kb, fmt.bk, fmt.bn,
            ptr(b_scales), ptr(b2_scales if has_gate else None), scale_mode,
            ptr(bias), out.data_ptr(), _DT[dtype_name(out.dtype)], n, act,
            bm, bn_chunk, kc, int(int_acc), variant, stream)
    return args, bias  # the converted bias must outlive the launch call


def _launch(name, a4, b_packed, n, counts, *, b2_packed, bm, b_scales,
            b2_scales, out_dtype, epilogue, bias, fmt) -> torch.Tensor:
    """Allocate [E, S, C, n] and launch the kernel on it (CUDA tensors)."""
    if a4.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu; got {a4.device}")
    e, s, c, _ = a4.shape
    out = torch.empty((e, s, c, n), dtype=out_dtype, device=a4.device)
    with torch.cuda.device(a4.device):
        stream = torch.cuda.current_stream(a4.device).cuda_stream
        args, keep = launch_args(a4, b_packed, n, counts, b2_packed=b2_packed,
                                 bm=bm, b_scales=b_scales,
                                 b2_scales=b2_scales, out=out,
                                 epilogue=epilogue, bias=bias, fmt=fmt,
                                 stream=stream)
        rc = _kernel()(*args)
        del keep
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


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
    launches the CUDA kernel (``bm`` is the scalar-FMA kernel's m-block).
    """
    kw = dict(b2_packed=b2_packed, bm=bm, b_scales=b_scales,
              b2_scales=b2_scales, epilogue=epilogue, bias=bias)
    if a.device.type == "cpu":
        return gemm_grouped_packed_ragged_plain(
            a, b_packed, n, counts, layout_b=layout_b, out_dtype=out_dtype,
            b_format=b_format, **kw)
    fmt, _ = _resolve(b_packed, layout_b, b_scales, b2_packed, b2_scales,
                      epilogue, b_format)
    out = _launch("gemm_grouped_packed_ragged", a, b_packed, n, counts,
                  out_dtype=out_dtype or a.dtype, fmt=fmt, **kw)
    gemm_grouped_packed_ragged.launches += 1
    return out


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
    grouped kernel with no counts."""
    kw = dict(b2_packed=b2_packed, bm=bm, b_scales=b_scales,
              b2_scales=b2_scales, epilogue=epilogue, bias=bias)
    if a.device.type == "cpu":
        return gemm_grouped_packed_plain(
            a, b_packed, n, layout_b=layout_b, out_dtype=out_dtype,
            b_format=b_format, **kw)
    fmt, _ = _resolve(b_packed, layout_b, b_scales, b2_packed, b2_scales,
                      epilogue, b_format)
    out = _launch("gemm_grouped_packed", a[:, None], b_packed, n, None,
                  out_dtype=out_dtype or a.dtype, fmt=fmt, **kw)
    gemm_grouped_packed.launches += 1
    return out[:, 0]


gemm_grouped_packed_ragged.launches = 0
gemm_grouped_packed.launches = 0
