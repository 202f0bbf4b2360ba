"""K7 — ``gemm_tiled``: blocked GEMM over strided, unpacked operands with
the alpha/beta, bias and activation epilogue fused into the store (the
paper's "Tiling" strategy; "Intrinsic" is the same kernel launched as one
block). The CUDA kernel is ``csrc/gemm_tiled.cu``; its plain torch version
:func:`gemm_tiled_plain` sits beside it.

The kernel reads A and B through their strides: a transposed view (the raw
LM head, ``table.t()``) is read as it lies, never copied. :func:`tiled_body`
picks the body of each call (bf16 / f16 operands that TMA can read take
``tc_stream`` up to 16 rows and ``wgmma`` above, through tensor maps over
the operands themselves), and ``gemm_tiled.variants`` counts the launches
by body.

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
from repro_torch.kernels import build, counts_launches
from repro_torch.kernels.common import (EPILOGUE_CODES, acc_dtype_for, cdiv,
                                        finalize, kernel_epilogue_name,
                                        plain_acc)

# dtype codes of the CUDA sources (enum DType in gemm_common.cuh).
DT = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3, "int32": 5}
IN_DTYPES = ("float32", "bfloat16", "float16", "int8")
OUT_DTYPES = ("float32", "bfloat16", "float16", "int32")
# Kernel variants (enums Variant / TcVariant of the CUDA sources): the
# CUDA-core bodies, blocked_mma's decode / prefill tiles, and the TMA bodies.
FMA, MMA_DECODE, MMA_PREFILL, WGMMA, TC_STREAM = 0, 1, 2, 3, 4
TC_BOX = 64   # a TMA box's contiguous axis, elements (the TMA bodies' k-box)
H100_SMS = 132
ALL_BLOCKS = 2 ** 31 - 1

# K7's bodies by name (the ``.variants`` keys).
TILED_BODIES = ("tc_stream", "wgmma", "mma_general", "fma_stream",
                "fma_tiled")

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
    """blocked_mma's tiles for bf16 / f16 (the general body of K6 and K7,
    mma.sync): the decode variant (16 x 16 tiles) up to 16 rows, the
    prefill variant (64 x 64) above. f32 and int8 take the CUDA-core
    bodies (f32 in full f32, as the reference), planned by
    :func:`fma_geometry`."""
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


def tc_stream_split(kb: int, nb: int) -> tuple:
    """(splits, kt_chunk) of the ``tc_stream`` bodies: Kb k-tiles cut into
    chunks of whole tiles so that nb 64-column stripes give at least two
    blocks an SM (as far as Kb allows); every split non-empty."""
    want = cdiv(2 * H100_SMS, nb)
    chunk = max(1, kb // want)
    return cdiv(kb, chunk), chunk


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


def _check_contract(a: torch.Tensor, b: torch.Tensor):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} do not "
                         f"contract")


def tiled_strides(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(sam, sak, sbk, sbn): A's and B's element strides as the kernel takes
    them. A dim of extent 1 is never stepped, so torch leaves its stride
    free; it is replaced here so that a [1, K] A or a [K, 1] B keeps the
    layout it has: a unit stride for an extent-1 contraction axis, and for
    an extent-1 row axis the row's extent rounded up to 16 bytes. A B of
    one column is k-contiguous when its k-stride is 1, else n-contiguous;
    a B of one row likewise the other way round."""
    (m, k), n = a.shape, b.shape[1]
    per16 = max(1, 16 // a.element_size())

    def row(extent):
        return cdiv(extent, per16) * per16
    sam, sak = a.stride()
    sbk, sbn = b.stride()
    if k == 1:
        sak = 1
    if m == 1:
        sam = row(k)
    if k == 1 and n == 1:
        sbk, sbn = row(1), 1
    elif n == 1:
        sbn = row(k) if sbk == 1 else 1
    elif k == 1:
        sbk = row(n) if sbn == 1 else 1
    return sam, sak, sbk, sbn


def tiled_tma_aligned(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether A and B can be read through TMA tensor maps as they lie: both
    bases 16-byte aligned; A k-contiguous with a row stride that is a
    multiple of 16 bytes and at least K; B n-contiguous with a row stride a
    multiple of 16 bytes and at least N, or k-contiguous (a transposed view
    such as ``table.t()``) with one at least K. Strides of extent-1 dims
    are normalised first (:func:`tiled_strides`)."""
    (_, k), n = a.shape, b.shape[1]
    sam, sak, sbk, sbn = tiled_strides(a, b)
    item = a.element_size()

    def rows_ok(stride, width):
        return (stride * item) % 16 == 0 and stride >= width
    b_ok = ((sbn == 1 and rows_ok(sbk, n)) or (sbk == 1 and rows_ok(sbn, k)))
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and sak == 1
            and rows_ok(sam, k) and b_ok)


def tiled_body(dtype: torch.dtype, m: int, tma_ok: bool) -> str:
    """K7's body for an [m, K] x [K, N] product of ``dtype`` (``tma_ok``:
    what :func:`tiled_tma_aligned` says of the operands):

    * bf16 / f16 on operands TMA can read: ``tc_stream`` (TMA + mma.sync,
      split K) up to 16 rows, ``wgmma`` (TMA + wgmma) above;
    * bf16 / f16 otherwise (an unaligned base, a transposed A, a row
      stride off 16 bytes): ``mma_general`` (blocked_mma, any strides);
    * f32 / int8: ``fma_stream`` up to 16 rows, ``fma_tiled`` above (CUDA
      cores, :func:`fma_geometry`).
    """
    if dtype_name(dtype) in ("bfloat16", "float16"):
        if tma_ok:
            return "tc_stream" if m <= STREAM_ROWS else "wgmma"
        return "mma_general"
    return "fma_stream" if m <= STREAM_ROWS else "fma_tiled"


def launch_args(a: torch.Tensor, b: torch.Tensor, c, *, alpha, beta, out,
                epilogue, bias, single_block, stream) -> tuple:
    """Check the operands against what the kernel takes and build the C
    entry point's argument tuple (raises ``ValueError`` on anything else).
    Returns ``(args, keep, body)``: ``keep`` holds the converted C and bias
    and the split-K workspace, which must outlive the launch.
    ``single_block`` gives a grid of one block and no split."""
    _check_contract(a, b)
    if a.dtype != b.dtype or dtype_name(a.dtype) not in IN_DTYPES:
        raise ValueError(f"kernel takes A and B of one dtype in {IN_DTYPES}; "
                         f"got {a.dtype} and {b.dtype}")
    for name, t in (("B", b), ("out", out)):
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, A on {a.device}")
    if dtype_name(out.dtype) not in OUT_DTYPES:
        raise ValueError(f"kernel stores {OUT_DTYPES}; got {out.dtype}")
    if min(a.stride() + b.stride()) < 0:
        raise ValueError("kernel takes non-negative strides")
    m, k = a.shape
    n = b.shape[1]
    if tuple(out.shape) != (m, n) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous [{m}, {n}]; got "
                         f"{tuple(out.shape)}")
    if k == 0:
        raise ValueError("kernel takes K > 0")
    int_acc = acc_dtype_for(a.dtype) == torch.int32
    c32, bias32 = epilogue_operands(c, bias, m, n, int_acc, a.device)
    sam, sak, sbk, sbn = tiled_strides(a, b)
    body = tiled_body(a.dtype, m, tiled_tma_aligned(a, b))
    ws = None
    if body == "tc_stream":
        kb = cdiv(k, TC_BOX)
        splits, chunk = ((1, kb) if single_block
                         else tc_stream_split(kb, cdiv(n, TC_BOX)))
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device)
        variant, plan = TC_STREAM, (0, 0, splits, chunk,
                                    None if ws is None else ws.data_ptr())
    elif body == "wgmma":
        variant, plan = WGMMA, (0, 0, 1, 0, None)
    elif body == "mma_general":
        variant, plan = pick_variant(a.dtype, m), (0, 0, 1, 0, None)
    else:
        variant = FMA
        plan, ws = fma_args(m, k, n, acc_dtype_for(a.dtype), a.device,
                            item=a.element_size(), b_kfast=sbk == 1,
                            single_block=single_block)
    args = (a.data_ptr(), sam, sak, b.data_ptr(), sbk, sbn,
            DT[dtype_name(a.dtype)], m, k, n,
            None if bias32 is None else bias32.data_ptr(),
            None if c32 is None else c32.data_ptr(), n, float(alpha),
            float(beta if c is not None else 0.0), out.data_ptr(),
            DT[dtype_name(out.dtype)],
            EPILOGUE_CODES[kernel_epilogue_name(epilogue)], variant, *plan,
            1 if single_block else ALL_BLOCKS, stream)
    return args, (c32, bias32, ws), body


def _launch(a, b, c, *, alpha, beta, out_dtype, epilogue, bias,
            single_block, stream) -> torch.Tensor:
    """Allocate the [M, N] output, launch the kernel on it on ``stream``
    and count the launch by body (an empty output launches nothing)."""
    _check_contract(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    args, keep, body = launch_args(a, b, c, alpha=alpha, beta=beta, out=out,
                                   epilogue=epilogue, bias=bias,
                                   single_block=single_block, stream=stream)
    rc = _kernel()(*args)
    del keep
    if rc != 0:
        raise RuntimeError(f"gemm_tiled launch failed ({body}): CUDA error "
                           f"{rc}")
    gemm_tiled.launches += 1
    gemm_tiled.variants[body] += 1
    return out


def gemm_tiled(a: torch.Tensor, b: torch.Tensor,
               c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
               beta: float = 0.0, bm: int = 64, out_dtype=None, epilogue: str = "none",
               bias: Optional[torch.Tensor] = None,
               single_block: bool = False) -> torch.Tensor:
    """``C <- epilogue(alpha * A @ B + beta * C + bias)``, A [M, K] and B
    [K, N] of one dtype, read through their strides.

    ``bm`` is the reference's m-block and does not change the launch: each
    body stages its own tiles (:func:`tiled_body` picks the body). A
    ``single_block`` call runs the whole problem in ONE block, the
    reference's one-step grid of the "intrinsic" strategy. On the CPU this
    is :func:`gemm_tiled_plain`.
    """
    if a.device.type == "cpu":
        return gemm_tiled_plain(a, b, c, alpha=alpha, beta=beta, bm=bm,
                                out_dtype=out_dtype, epilogue=epilogue,
                                bias=bias, single_block=single_block)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_tiled runs on cuda or cpu; got {a.device}")
    out_dtype = out_dtype or (c.dtype if c is not None else a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        return _launch(a, b, c, alpha=alpha, beta=beta, out_dtype=out_dtype,
                       epilogue=epilogue, bias=bias,
                       single_block=single_block, stream=stream)


counts_launches(gemm_tiled, TILED_BODIES)
