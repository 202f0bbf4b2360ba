"""K8 — ``matmul_vsx_like`` and ``matmul_vsx_like_packed``: A @ B as
rank-1 broadcast-FMA updates on the CUDA cores, with no tensor-core
instruction — the paper's generic vector-unit ("VSX") lowering, the
baseline of the matrix-engine comparison (Fig. 10b). The CUDA kernel is
``csrc/gemm_vsx_like.cu`` (both variants); the plain torch versions
:func:`matmul_vsx_like_plain` and :func:`matmul_vsx_like_packed_plain` sit
beside it.

Operands are widened to the accumulator type (f32, or i32 for int8) and the
accumulator is stored as ``out_dtype`` with no other epilogue. Both entry
points run the two CUDA-core bodies of ``csrc/gemm_blocked.cuh``, planned
by :func:`repro_torch.kernels.gemm_tiled.fma_geometry`: ``fma_stream`` up
to 16 rows, ``fma_tiled`` above; each wrapper counts its launches by body
in ``.variants``.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.dtypes import dtype_name
from repro_torch.core.tile_format import TileFormat, cdiv
from repro_torch.kernels import build, counts_launches
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels.common import acc_dtype_for, plain_acc
from repro_torch.kernels.ref import unpack_b_ref

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # a, sam, sak, dt
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,            # M, K, b, packed
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,     # sbk, sbn, b_col, Kb
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,            # bk, bn, N, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,               # dt, body, tile, splits
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,                       # kchunk, ws, stream
]
VARIANTS = ("fma_tiled", "fma_stream")   # by FmaPlan body


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("gemm_vsx_like").matmul_vsx_like_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def matmul_vsx_like_plain(a: torch.Tensor, b: torch.Tensor, *, bm: int = 64,
                          out_dtype=None) -> torch.Tensor:
    """The plain torch version: the product on the accumulator type, cast
    to ``out_dtype`` (default A's dtype)."""
    del bm
    return plain_acc(a, b).to(out_dtype or a.dtype)


def matmul_vsx_like_packed_plain(a: torch.Tensor, b_packed: torch.Tensor,
                                 n: int, *, bm: int = 64,
                                 layout_b: str = "row",
                                 out_dtype=None) -> torch.Tensor:
    """The plain torch version of the packed-B variant."""
    del bm
    b = unpack_b_ref(b_packed, a.shape[1], n, layout_b)
    return plain_acc(a, b).to(out_dtype or a.dtype)


def _launch(a, b, n, *, packed_fmt, bm, out_dtype, wrapper):
    """Launch the kernel; a launch adds one to ``wrapper.launches``, and an
    empty output launches nothing."""
    name = wrapper.__name__
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu; got {a.device}")
    if a.dim() != 2 or b.device != a.device:
        raise ValueError(f"A must be [M, K] on B's device; got "
                         f"{tuple(a.shape)} on {a.device}, B on {b.device}")
    dt = dtype_name(a.dtype)
    if b.dtype != a.dtype or dt not in gt.IN_DTYPES:
        raise ValueError(f"kernel takes A and B of one dtype in "
                         f"{gt.IN_DTYPES}; got {a.dtype} and {b.dtype}")
    m, k = a.shape
    out_dtype = out_dtype or a.dtype
    if dtype_name(out_dtype) not in gt.OUT_DTYPES:
        raise ValueError(f"kernel stores {gt.OUT_DTYPES}; got {out_dtype}")
    if min(a.stride()) < 0:
        raise ValueError("kernel takes non-negative strides")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        raise ValueError("kernel takes K > 0")
    if packed_fmt is None:
        if min(b.stride()) < 0:
            raise ValueError("kernel takes non-negative strides")
        b_args = (0, b.stride(0), b.stride(1), 0, 0, 0, 0)
        b_kfast, align = b.stride(0) == 1, 16
    else:
        fmt = packed_fmt
        if not b.is_contiguous() or b.dim() != 4 \
                or cdiv(k, fmt.bk) != b.shape[1] or n > b.shape[0] * fmt.bn:
            raise ValueError(f"packed B {tuple(b.shape)} does not fit A "
                             f"{tuple(a.shape)} and n={n}")
        b_args = (1, 0, 0, int(fmt.layout == "col"), b.shape[1], fmt.bk,
                  fmt.bn)
        b_kfast, align = fmt.layout == "col", fmt.bk
    del bm  # the reference's m-block; the plan comes from the shape
    fma, ws = gt.fma_args(m, k, n, acc_dtype_for(a.dtype), a.device,
                          item=a.element_size(), b_kfast=b_kfast, align=align)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _kernel()(a.data_ptr(), a.stride(0), a.stride(1), gt.DT[dt], m, k,
                       b.data_ptr(), *b_args, n, out.data_ptr(),
                       gt.DT[dtype_name(out_dtype)], *fma, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    wrapper.launches += 1
    wrapper.variants[VARIANTS[fma[0]]] += 1
    return out


def matmul_vsx_like(a: torch.Tensor, b: torch.Tensor, *, bm: int = 64,
                    out_dtype=None) -> torch.Tensor:
    """A [M, K] @ B [K, N] (any strides) by rank-1 CUDA-core updates. ``bm``
    is the reference's m-block; the kernel's plan comes from the shape. On
    the CPU this is :func:`matmul_vsx_like_plain`."""
    if a.device.type == "cpu":
        return matmul_vsx_like_plain(a, b, bm=bm, out_dtype=out_dtype)
    if b.dim() != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} do not "
                         f"contract")
    return _launch(a, b, b.shape[1], packed_fmt=None, bm=bm,
                   out_dtype=out_dtype, wrapper=matmul_vsx_like)


def matmul_vsx_like_packed(a: torch.Tensor, b_packed: torch.Tensor, n: int,
                           *, bm: int = 64, layout_b: str = "row",
                           out_dtype=None) -> torch.Tensor:
    """A [M, K] @ unpack(B) with B tile-major from ``pack_b`` (float or
    int8, unscaled), by rank-1 CUDA-core updates. On the CPU this is
    :func:`matmul_vsx_like_packed_plain`."""
    if a.device.type == "cpu":
        return matmul_vsx_like_packed_plain(a, b_packed, n, bm=bm,
                                            layout_b=layout_b,
                                            out_dtype=out_dtype)
    fmt = TileFormat.from_packed(b_packed, layout_b)
    return _launch(a, b_packed, n, packed_fmt=fmt, bm=bm, out_dtype=out_dtype,
                   wrapper=matmul_vsx_like_packed)


counts_launches(matmul_vsx_like, VARIANTS)
counts_launches(matmul_vsx_like_packed, VARIANTS)
