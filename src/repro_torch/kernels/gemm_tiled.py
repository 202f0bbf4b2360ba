"""K7 — ``gemm_tiled``: blocked GEMM over strided, unpacked operands with
the alpha/beta, bias and activation epilogue fused into the store (the
paper's "Tiling" strategy; "Intrinsic" is the same kernel launched as one
block). The CUDA kernel is ``csrc/gemm_tiled.cu``; its plain torch version
:func:`gemm_tiled_plain` sits beside it.

The kernel reads A and B through their strides: a transposed view (the raw
LM head, ``table.t()``) is streamed as it lies, never copied.

The wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.core.dtypes import dtype_name
from repro_torch.kernels import build
from repro_torch.kernels.common import (EPILOGUE_CODES, acc_dtype_for, cdiv,
                                        finalize, kernel_epilogue_name,
                                        plain_acc)

# dtype codes of the CUDA sources (enum DType in gemm_common.cuh).
DT = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3, "int32": 5}
IN_DTYPES = ("float32", "bfloat16", "float16", "int8")
OUT_DTYPES = ("float32", "bfloat16", "float16", "int32")
FMA, MMA_DECODE, MMA_PREFILL = 0, 1, 2   # kernel variants (enum Variant)
H100_SMS = 132
ALL_BLOCKS = 2 ** 31 - 1

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,            # a, sam, sak
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,            # b, sbk, sbn
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # dt, M, K, N
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,              # bias, c, ldc
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,    # alpha, beta, out, dt
    ctypes.c_int, ctypes.c_int,                                       # act, variant
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # fma body, tile, splits, kchunk
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,                   # ws, max_blocks, stream
]

# The CUDA-core bodies of gemm_blocked.cuh (FmaPlan::body).
FMA_TILED, FMA_STREAM = 0, 1
STREAM_ROWS = 16     # fma_stream takes at most this many rows
MIN_KCHUNK = 128     # the least k a split covers: partial sums stay a few % of B


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("gemm_tiled").gemm_tiled_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pick_variant(dtype: torch.dtype, m: int) -> int:
    """Tensor cores (mma.sync) for bf16 / f16: the decode variant (16 x 16
    tiles) up to 16 rows, the prefill variant (64 x 64) above. f32 and int8
    take the CUDA-core bodies (f32 in full f32, as the reference), planned
    by :func:`fma_geometry`."""
    if dtype_name(dtype) in ("bfloat16", "float16"):
        return MMA_DECODE if m <= 16 else MMA_PREFILL
    return FMA


def vec_elems(item: int) -> int:
    """Elements of one staging vector (``vec_elems`` of the CUDA source):
    16 bytes, at most 8 elements."""
    return min(8, 16 // item)


def stream_bn(item: int, b_kfast: bool) -> int:
    """Columns of one fma_stream work item (``stream_bn`` of the source)."""
    return 32 if b_kfast else 8 * vec_elems(item)


def split_k(k: int, tiles: int, align: int, target: int) -> tuple:
    """(splits, kchunk): K cut into chunks of ``kchunk`` (a multiple of
    ``align``, at least MIN_KCHUNK rounded up to it), each non-empty, so
    that ``tiles`` output tiles give the card at least ``target`` blocks
    (as far as K allows)."""
    floor = cdiv(MIN_KCHUNK, align) * align
    if tiles >= target:
        return 1, max(cdiv(k, align) * align, align)
    want = cdiv(target, tiles)
    kchunk = max(floor, (k // want) // align * align)
    return cdiv(k, kchunk), kchunk


def fma_geometry(m: int, k: int, n: int, *, item: int, b_kfast: bool,
                 align: int = 16, single_block: bool = False) -> tuple:
    """The CUDA-core plan ``(body, tile, splits, kchunk)`` of
    gemm_blocked.cuh for an [m, k] x [k, n] product of ``item``-byte
    elements: up to STREAM_ROWS rows fma_stream with the least of 4 / 16
    rows that holds m; above, fma_tiled with 64 x 64 tiles (tile 1) up to
    64 rows, else 128 x 128 (tile 2). K is split (on multiples of
    ``align``: a packed operand's bk) until the card holds two blocks an
    SM (fma_stream, and the 64 x 64 tiles, of which two fit an SM) or one
    (the 128 x 128 tiles); never for ``single_block``."""
    align = align * 16 // math.gcd(align, 16)
    target = 2 * H100_SMS
    if m <= STREAM_ROWS:
        body, tile = FMA_STREAM, (4 if m <= 4 else 16)
        tiles = cdiv(n, stream_bn(item, b_kfast))
    else:
        body, tile = FMA_TILED, (1 if m <= 64 else 2)
        tiles = cdiv(m, 64 * tile) * cdiv(n, 64 * tile)
        target = H100_SMS if tile == 2 else target
    if single_block:
        return body, tile, 1, cdiv(k, align) * align
    return (body, tile) + split_k(k, tiles, align, target)


def fma_args(m: int, k: int, n: int, acc_dtype, device, **geometry) -> tuple:
    """The FmaPlan arguments of a C entry point, ``(body, tile, splits,
    kchunk, workspace)``: the workspace is a [splits, m, n] tensor of the
    accumulator type when K is split (returned too, to outlive the launch)."""
    body, tile, splits, kchunk = fma_geometry(m, k, n, **geometry)
    ws = (torch.empty((splits, m, n), dtype=acc_dtype, device=device)
          if splits > 1 else None)
    return (body, tile, splits, kchunk, None if ws is None else ws.data_ptr()), ws


def epilogue_operands(c, bias, m: int, n: int, int_acc: bool, device):
    """C and the bias as the kernels take them: contiguous f32, cast to i32
    first for an integer product (the reference casts both to the
    accumulator's type)."""
    def conv(t, shape, name):
        if t is None:
            return None
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}; got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, operands on {device}")
        return (t.to(torch.int32) if int_acc else t).to(
            torch.float32).contiguous()
    return conv(c, (m, n), "c"), conv(bias, (n,), "bias")


def gemm_tiled_plain(a: torch.Tensor, b: torch.Tensor,
                     c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
                     beta: float = 0.0, bm: int = 64, out_dtype=None,
                     epilogue: str = "none",
                     bias: Optional[torch.Tensor] = None,
                     single_block: bool = False) -> torch.Tensor:
    """The plain torch version: the product on the accumulator type (f32,
    or i32 for int8), then the store epilogue. The blocking arguments do
    not change the function."""
    del bm, single_block
    out_dtype = out_dtype or (c.dtype if c is not None else a.dtype)
    return finalize(plain_acc(a, b), c, alpha, beta, bias, epilogue,
                    out_dtype)


def gemm_tiled(a: torch.Tensor, b: torch.Tensor,
               c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
               beta: float = 0.0, bm: int = 64, out_dtype=None, epilogue: str = "none",
               bias: Optional[torch.Tensor] = None,
               single_block: bool = False) -> torch.Tensor:
    """``C <- epilogue(alpha * A @ B + beta * C + bias)``, A [M, K] and B
    [K, N] of one dtype, read through their strides.

    ``bm`` is the reference's m-block and does not change the launch: the
    CUDA-core bodies take their plan from :func:`fma_geometry`, the
    tensor-core bodies stage fixed tiles (16 x 16 up to 16 rows, 64 x 64
    above). ``single_block``
    runs the whole problem in ONE block, the reference's one-step grid of
    the "intrinsic" strategy. On the CPU this is :func:`gemm_tiled_plain`.
    """
    if a.device.type == "cpu":
        return gemm_tiled_plain(a, b, c, alpha=alpha, beta=beta, bm=bm,
                                out_dtype=out_dtype, epilogue=epilogue,
                                bias=bias, single_block=single_block)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_tiled runs on cuda or cpu; got {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} do not "
                         f"contract")
    if a.dtype != b.dtype or dtype_name(a.dtype) not in IN_DTYPES:
        raise ValueError(f"kernel takes A and B of one dtype in {IN_DTYPES}; "
                         f"got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"B on {b.device}, A on {a.device}")
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or (c.dtype if c is not None else a.dtype)
    if dtype_name(out_dtype) not in OUT_DTYPES:
        raise ValueError(f"kernel stores {OUT_DTYPES}; got {out_dtype}")
    if min(a.stride() + b.stride()) < 0:
        raise ValueError("kernel takes non-negative strides")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("kernel takes K > 0")
    int_acc = acc_dtype_for(a.dtype) == torch.int32
    c32, bias32 = epilogue_operands(c, bias, m, n, int_acc, a.device)
    variant = pick_variant(a.dtype, m)
    fma, ws = (0, 0, 1, 0, None), None
    if variant == FMA:
        fma, ws = fma_args(m, k, n, acc_dtype_for(a.dtype), a.device,
                           item=a.element_size(), b_kfast=b.stride(0) == 1,
                           single_block=single_block)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _kernel()(
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), DT[dtype_name(a.dtype)],
            m, k, n, None if bias32 is None else bias32.data_ptr(),
            None if c32 is None else c32.data_ptr(), n, float(alpha),
            float(beta if c is not None else 0.0), out.data_ptr(),
            DT[dtype_name(out_dtype)],
            EPILOGUE_CODES[kernel_epilogue_name(epilogue)], variant, *fma,
            1 if single_block else ALL_BLOCKS, stream)
    if rc != 0:
        raise RuntimeError(f"gemm_tiled launch failed: CUDA error {rc}")
    gemm_tiled.launches += 1
    return out


gemm_tiled.launches = 0
