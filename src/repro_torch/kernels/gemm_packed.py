"""The packed-operand GEMMs, each with the alpha-beta / bias / activation
epilogue fused into the store:

  * ``gemm_packed_fused_a`` (K1) — natural-layout A against a packed B
    (float, or int8 / int4 tiles with scales, widened in the kernel).
    CUDA kernel ``csrc/gemm_packed_fused_a.cu``, plain torch version
    :func:`gemm_packed_fused_a_plain`; :func:`fused_a_body` picks its body
    per call, and ``.variants`` counts the launches by body.
  * ``gemm_packed`` (K6) — BOTH operands packed tile-major (the paper's
    Tiling+Packing: ``pack_a`` + ``pack_b`` + this kernel). CUDA kernel
    ``csrc/gemm_packed.cu``, plain torch version :func:`gemm_packed_plain`.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.dtypes import dtype_name
from repro_torch.core.tile_format import TileFormat
from repro_torch.kernels import build, counts_launches
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels.common import (EPILOGUE_CODES, KERNEL_EPILOGUES,
                                        acc_dtype_for, cdiv, finalize,
                                        kernel_epilogue_name, plain_acc)
from repro_torch.kernels.gemm_tiled import (TC_BOX, TC_STREAM, WGMMA,
                                            tc_stream_split)
from repro_torch.kernels.ref import (fused_packed_acc_ref, unpack_a_ref,
                                     unpack_b_ref)

# dtype codes of the CUDA source (enum DType).
_DT = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3, "int4": 4,
       "int32": 5}
_A_DTYPES = ("float32", "bfloat16", "float16", "int8")
_B_DTYPES = ("float32", "bfloat16", "float16", "int8", "int4")
_OUT_DTYPES = ("float32", "bfloat16", "float16", "int32")
_BM_CHOICES = (16, 32, 48, 64)
_BN_CHOICES = (64, 48, 32, 16)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,   # a, dt, lda, M
    ctypes.c_int,                                                     # K
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,        # b, dt, col, Nb
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                         # Kb, bk, bn
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # scales, mode, bias, c
    ctypes.c_longlong, ctypes.c_float, ctypes.c_float,                # ldc, alpha, beta
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,        # out, dt, N, act
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # body, BM, BN, KC
    ctypes.c_int,                                                     # int_acc
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # fma body, tile, splits, kchunk
    ctypes.c_void_p, ctypes.c_void_p,                                 # ws, stream
]

# The quantized bodies' tile variants (mma_quant decode / prefill, fma_quant).
FMA, MMA_DECODE, MMA_PREFILL = 0, 1, 2

# K1's bodies by name (the ``.variants`` keys) and their codes in the CUDA
# source (enum FusedBody; mma_quant is 1 or 2 by its tile variant, fma_*
# one code with the FmaPlan choosing the body).
FUSED_BODIES = ("tc_stream", "wgmma", "tc_stream_q", "wgmma_q",
                "mma_general", "fma_stream", "fma_tiled", "mma_quant",
                "fma_quant")
_BODY_CODE = {"fma_quant": 0, "wgmma": 3, "tc_stream": 4, "mma_general": 5,
              "fma_tiled": 6, "fma_stream": 6, "tc_stream_q": 7,
              "wgmma_q": 8}
# The bodies that cut Kb into splits (tc_stream_split) and reduce them.
SPLIT_BODIES = ("tc_stream", "tc_stream_q")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("gemm_packed_fused_a")
    fn = lib.gemm_packed_fused_a_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _resolve(a, b_packed, layout_b, b_scales, b_format, c, out_dtype):
    fmt = b_format if b_format is not None else TileFormat.from_packed(
        b_packed, layout_b, has_scales=b_scales is not None)
    out_dtype = out_dtype or (c.dtype if c is not None else a.dtype)
    return fmt, out_dtype


def gemm_packed_fused_a_plain(a: torch.Tensor, b_packed: torch.Tensor,
                              n: int, c: Optional[torch.Tensor] = None, *,
                              bm: int = 64, alpha: float = 1.0,
                              beta: float = 0.0, layout_b: str = "row",
                              b_scales: Optional[torch.Tensor] = None,
                              out_dtype=None, epilogue: str = "none",
                              bias: Optional[torch.Tensor] = None,
                              b_format: Optional[TileFormat] = None
                              ) -> torch.Tensor:
    """The plain torch version: ``fused_packed_acc_ref`` (f32 accumulator,
    quantized tiles dequantized first) plus the store epilogue."""
    fmt, out_dtype = _resolve(a, b_packed, layout_b, b_scales, b_format, c,
                              out_dtype)
    acc = fused_packed_acc_ref(a, b_packed, n, layout_b=fmt.layout, bm=bm,
                               b_scales=b_scales, fmt=fmt)
    out = alpha * acc
    if c is not None and beta != 0:
        out = out + beta * c.to(acc.dtype)
    if bias is not None:
        out = out + bias.to(acc.dtype)
    out = KERNEL_EPILOGUES[kernel_epilogue_name(epilogue)](out)
    return out.to(out_dtype)


def _pick_bn(bn: int, blocks_per_col: int) -> int:
    """The kernel's column chunk: the widest that still gives the card more
    blocks than SMs (decode-shaped M), else the narrowest that divides bn."""
    fits = [w for w in _BN_CHOICES if bn % w == 0]
    for w in fits:
        if blocks_per_col * (bn // w) >= gt.H100_SMS:
            return w
    return fits[-1]


def pick_variant(a_dtype: torch.dtype, fmt: TileFormat, m: int) -> int:
    """The quantized bodies' tile variant: mma.sync for bf16/f16 activations
    with B of the same type or int8/int4 (exact in the activation type),
    decode tiles up to 16 rows and prefill tiles above; the scalar FMAs for
    everything else (f32 or int8 activations, f32 B). It decides between
    mma_quant and fma_quant where :func:`fused_a_body` routes a call to the
    quantized bodies."""
    a_dt = dtype_name(a_dtype)
    if a_dt in ("bfloat16", "float16") and fmt.dtype in (a_dt, "int8", "int4"):
        if m <= 16 and fmt.bk % 64 == 0:
            return MMA_DECODE
        if m > 16 and fmt.bk % 32 == 0 and fmt.bn % 64 == 0:
            return MMA_PREFILL
    return FMA


def tma_aligned(a: torch.Tensor, b_packed: torch.Tensor) -> bool:
    """Whether natural A and the packed stack can be read through TMA
    tensor maps: 16-byte aligned bases, A's row stride a multiple of 16
    bytes and at least K (rows that do not overlap)."""
    lda, item = a.stride(0), a.element_size()
    return (a.data_ptr() % 16 == 0 and b_packed.data_ptr() % 16 == 0
            and (lda * item) % 16 == 0 and lda >= a.shape[1])


def fused_a_body(a_dtype: torch.dtype, fmt: TileFormat, m: int, *,
                 scaled: bool, tma_ok: bool) -> str:
    """K1's body for an [m, K] A of ``a_dtype`` against packed tiles of
    ``fmt`` (``scaled``: the tiles carry scales; ``tma_ok``: what
    :func:`tma_aligned` says of the operands):

    * bf16 / f16 A against unscaled tiles of the same type: the TMA bodies
      for bn 64 and bk a multiple of 64 on aligned operands, ``tc_stream``
      up to 16 rows and ``wgmma`` above; ``mma_general`` (blocked_mma) for
      any other geometry or alignment;
    * bf16 / f16 A against int8 / int4 tiles (tile, col or no scales) of
      the same geometry on aligned operands: the quantized TMA bodies,
      ``tc_stream_q`` up to 16 rows and ``wgmma_q`` above;
    * f32 A against f32 tiles, int8 A against unscaled int8 tiles:
      ``fma_stream`` up to 16 rows, ``fma_tiled`` above (CUDA cores);
    * every other pair (quantized tiles of other geometries or under a
      misaligned or f32 A, int4 under int8 A, mixed float types): the
      quantized bodies ``mma_quant`` / ``fma_quant``.
    """
    a_dt = dtype_name(a_dtype)
    tma_tiles = tma_ok and fmt.bn == TC_BOX and fmt.bk % TC_BOX == 0
    if not scaled and fmt.dtype == a_dt:
        if a_dt in ("bfloat16", "float16"):
            if tma_tiles:
                return "tc_stream" if m <= 16 else "wgmma"
            return "mma_general"
        if a_dt in ("float32", "int8"):
            return "fma_stream" if m <= gt.STREAM_ROWS else "fma_tiled"
    if (a_dt in ("bfloat16", "float16") and fmt.dtype in ("int8", "int4")
            and tma_tiles):
        return "tc_stream_q" if m <= 16 else "wgmma_q"
    return "fma_quant" if pick_variant(a_dtype, fmt, m) == FMA else "mma_quant"


def launch_args(a, b_packed, n, c, *, bm, alpha, beta, b_scales, out,
                epilogue, bias, fmt, stream) -> tuple:
    """Check the operands against what the kernel takes and build the C
    entry point's argument tuple (raises ``ValueError`` on anything else).
    Returns ``(args, keep, body)``: ``keep`` holds converted copies and the
    split-K workspace, which must outlive the launch."""
    m, k = a.shape
    nb, kb = b_packed.shape[:2]
    a_dt, b_dt = dtype_name(a.dtype), fmt.dtype
    int_acc = acc_dtype_for(a.dtype) == torch.int32
    if a_dt not in _A_DTYPES:
        raise ValueError(f"kernel takes A in {_A_DTYPES}; got {a_dt}")
    if b_dt not in _B_DTYPES or dtype_name(b_packed.dtype) != fmt.storage_dtype:
        raise ValueError(f"packed B of dtype {b_packed.dtype} does not match "
                         f"format {fmt}")
    if a.stride(1) != 1:
        raise ValueError("A must have unit column stride")
    if not b_packed.is_contiguous() or b_packed.dim() != 4:
        raise ValueError("packed B must be a contiguous [Nb, Kb, t0, t1] stack")
    if tuple(b_packed.shape[2:]) != fmt.storage_tile_shape:
        raise ValueError(f"packed B tiles {tuple(b_packed.shape[2:])} do not "
                         f"match format {fmt}")
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
        want = (nb,) if fmt.col_scaled else (nb, kb)
        if (tuple(b_scales.shape) != want or b_scales.dtype != torch.float32
                or not b_scales.is_contiguous()):
            raise ValueError(f"scales must be contiguous f32 {want}; got "
                             f"{tuple(b_scales.shape)} {b_scales.dtype}")
    for t in (b_packed, b_scales, bias, c):
        if t is not None and t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"bias must be [{n}]; got {tuple(bias.shape)}")
        bias = (bias.to(torch.int32) if int_acc else bias).to(torch.float32)
        bias = bias.contiguous()
    if c is not None:
        if tuple(c.shape) != (m, n):
            raise ValueError(f"c must be [{m}, {n}]; got {tuple(c.shape)}")
        c = (c.to(torch.int32) if int_acc else c).to(torch.float32).contiguous()
    body = fused_a_body(a.dtype, fmt, m, scaled=b_scales is not None,
                        tma_ok=tma_aligned(a, b_packed))
    ws = None
    if body in SPLIT_BODIES:
        splits, chunk = tc_stream_split(kb, cdiv(n, fmt.bn))
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device)
        plan = (0, 0, splits, chunk, None if ws is None else ws.data_ptr())
    elif body in ("fma_stream", "fma_tiled"):
        plan, ws = gt.fma_args(m, k, n, acc_dtype_for(a.dtype), a.device,
                               item=a.element_size(),
                               b_kfast=fmt.layout == "col", align=fmt.bk)
    else:
        plan = (0, 0, 1, 0, None)
    code = (pick_variant(a.dtype, fmt, m) if body == "mma_quant"
            else _BODY_CODE[body])
    bn_chunk = _pick_bn(fmt.bn, cdiv(m, bm))
    kc = 32 if fmt.bk % 32 == 0 else 16
    keep = (bias, c, ws)
    args = (a.data_ptr(), _DT[a_dt], a.stride(0), m, k,
            b_packed.data_ptr(), _DT[b_dt], int(fmt.layout == "col"), nb, kb,
            fmt.bk, fmt.bn,
            None if b_scales is None else b_scales.data_ptr(), scale_mode,
            None if bias is None else bias.data_ptr(),
            None if c is None else c.data_ptr(), n,
            float(alpha), float(beta if c is not None else 0.0),
            out.data_ptr(), _DT[dtype_name(out.dtype)], n,
            EPILOGUE_CODES[kernel_epilogue_name(epilogue)],
            code, bm, bn_chunk, kc, int(int_acc), *plan, stream)
    return args, keep, body


def gemm_packed_fused_a(a: torch.Tensor, b_packed: torch.Tensor, n: int,
                        c: Optional[torch.Tensor] = None, *, bm: int = 64,
                        alpha: float = 1.0, beta: float = 0.0,
                        layout_b: str = "row",
                        b_scales: Optional[torch.Tensor] = None,
                        out_dtype=None, epilogue: str = "none",
                        bias: Optional[torch.Tensor] = None,
                        b_format: Optional[TileFormat] = None) -> torch.Tensor:
    """``C[:m,:n] <- epilogue(alpha * A @ deq(B) + beta * C + bias)``.

    ``a`` [M, K] in its natural layout; ``b_packed`` from ``pack_b_ref``
    (tile-major, usually packed once at load); ``b_scales`` [Nb, Kb] per
    tile or [Nb] per column for a quantized format; ``b_format`` the
    authoritative :class:`TileFormat` (required for int4 and col scales).
    On the CPU this is :func:`gemm_packed_fused_a_plain`; on the card it
    launches the CUDA kernel on the body :func:`fused_a_body` picks
    (``bm``, 16, 32, 48 or 64, is the reference's m-block and the quantized
    fma body's; the other bodies choose their own tiles).
    """
    if a.device.type == "cpu":
        return gemm_packed_fused_a_plain(
            a, b_packed, n, c, bm=bm, alpha=alpha, beta=beta,
            layout_b=layout_b, b_scales=b_scales, out_dtype=out_dtype,
            epilogue=epilogue, bias=bias, b_format=b_format)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_packed_fused_a runs on cuda or cpu; got "
                         f"{a.device}")
    fmt, out_dtype = _resolve(a, b_packed, layout_b, b_scales, b_format, c,
                              out_dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        return _launch(a, b_packed, n, c, bm=bm, alpha=alpha, beta=beta,
                       b_scales=b_scales, out_dtype=out_dtype,
                       epilogue=epilogue, bias=bias, fmt=fmt, stream=stream)


def _launch(a, b_packed, n, c, *, out_dtype, **kw) -> torch.Tensor:
    """Allocate [M, n], launch the kernel on it on ``kw["stream"]`` and
    count the launch by body (no launch for M = 0)."""
    out = torch.empty((a.shape[0], n), dtype=out_dtype, device=a.device)
    if a.shape[0] == 0:
        return out
    args, keep, body = launch_args(a, b_packed, n, c, out=out, **kw)
    rc = _kernel()(*args)
    del keep
    if rc != 0:
        raise RuntimeError(f"gemm_packed_fused_a launch failed ({body}): "
                           f"CUDA error {rc}")
    gemm_packed_fused_a.launches += 1
    gemm_packed_fused_a.variants[body] += 1
    return out


counts_launches(gemm_packed_fused_a, FUSED_BODIES)


# ---------------------------------------------------------------------------
# gemm_packed (K6): both operands packed
# ---------------------------------------------------------------------------

_PACKED_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,                      # a, a_col, bm
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,                      # b, b_col, bn
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Kb, bk, dt, M
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # N, bias, c, ldc
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,    # alpha, beta, out, dt
    ctypes.c_int, ctypes.c_int,                                       # act, variant
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,           # fma body, tile, splits, kchunk
    ctypes.c_void_p, ctypes.c_void_p,                                 # ws, stream
]

# K6's bodies (variant codes of csrc/gemm_packed.cu, by name): the TMA
# bodies of gemm_wgmma.cuh (WGMMA, TC_STREAM), blocked_mma for any other
# bf16 / f16 geometry, and the CUDA-core bodies for f32 / int8.
PACKED_VARIANTS = ("wgmma", "tc_stream", "mma_general", "fma_tiled",
                   "fma_stream")


def packed_variant(dtype: torch.dtype, m: int, bm: int, bk: int, bn: int,
                   layout_a: str, aligned: bool) -> int:
    """K6's body for packed tiles of ``dtype``: bf16 / f16 take V_WGMMA
    when the tiles are 64 x 64 with bk a multiple of 64 (any layouts),
    V_TC_STREAM at decode (m <= 16) on 16-row "row" A tiles, bn 64 and bk
    a multiple of 64; both need 16-byte aligned stacks (``aligned``). Any
    other bf16 / f16 geometry takes blocked_mma (MMA_DECODE up to 16 rows,
    else MMA_PREFILL); f32 and int8 the CUDA-core bodies (FMA)."""
    if dtype_name(dtype) not in ("bfloat16", "float16"):
        return gt.FMA
    if aligned and bk % TC_BOX == 0 and bn == TC_BOX:
        if bm == TC_BOX:
            return WGMMA
        if bm == 16 and layout_a == "row" and m <= 16:
            return TC_STREAM
    return gt.pick_variant(dtype, m)


def variant_name(variant: int, fma_body: int) -> str:
    """The ``.variants`` key of a launch."""
    if variant == gt.FMA:
        return ("fma_tiled", "fma_stream")[fma_body]
    return {WGMMA: "wgmma", TC_STREAM: "tc_stream"}.get(variant, "mma_general")


@functools.lru_cache(maxsize=None)
def _packed_kernel():
    fn = build.load("gemm_packed").gemm_packed_launch
    fn.argtypes = _PACKED_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _packed_geometry(a_packed, b_packed, layout_a, layout_b):
    """(bm, bk, bn) of the two stacks, after checking that they contract."""
    for name, lay in (("layout_a", layout_a), ("layout_b", layout_b)):
        if lay not in ("row", "col"):
            raise ValueError(f"bad {name} {lay!r}")
    if a_packed.dim() != 4 or b_packed.dim() != 4:
        raise ValueError(f"packed A and B are [G, Kb, t0, t1] stacks; got "
                         f"{tuple(a_packed.shape)}, {tuple(b_packed.shape)}")
    bm, bk = (a_packed.shape[2:] if layout_a == "row"
              else a_packed.shape[2:][::-1])
    bk_b, bn = (b_packed.shape[2:] if layout_b == "row"
                else b_packed.shape[2:][::-1])
    if a_packed.shape[1] != b_packed.shape[1] or bk != bk_b:
        raise ValueError(f"packed A {tuple(a_packed.shape)} ({layout_a}) and "
                         f"B {tuple(b_packed.shape)} ({layout_b}) do not "
                         f"contract")
    return int(bm), int(bk), int(bn)


def gemm_packed_plain(a_packed: torch.Tensor, b_packed: torch.Tensor, m: int,
                      n: int, c: Optional[torch.Tensor] = None, *,
                      alpha: float = 1.0, beta: float = 0.0,
                      layout_a: str = "row", layout_b: str = "row",
                      out_dtype=None, epilogue: str = "none",
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain torch version: unpack both stacks, the product over the
    whole padded depth on the accumulator type, then the store epilogue."""
    _packed_geometry(a_packed, b_packed, layout_a, layout_b)
    kdim = a_packed.shape[1] * (a_packed.shape[3] if layout_a == "row"
                                else a_packed.shape[2])
    a = unpack_a_ref(a_packed, m, kdim, layout_a)
    b = unpack_b_ref(b_packed, kdim, n, layout_b)
    out_dtype = out_dtype or (c.dtype if c is not None else a_packed.dtype)
    return finalize(plain_acc(a, b), c, alpha, beta, bias, epilogue,
                    out_dtype)


def gemm_packed(a_packed: torch.Tensor, b_packed: torch.Tensor, m: int,
                n: int, c: Optional[torch.Tensor] = None, *,
                alpha: float = 1.0, beta: float = 0.0, layout_a: str = "row",
                layout_b: str = "row", out_dtype=None, epilogue: str = "none",
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C[:m,:n] <- epilogue(alpha * unpack(A) @ unpack(B) + beta * C +
    bias)``; ``a_packed`` from ``pack_a`` ([Mb, Kb, bm, bk] "row" or
    [Mb, Kb, bk, bm] "col"), ``b_packed`` from ``pack_b`` (float or int8,
    unscaled), one element dtype. On the CPU this is
    :func:`gemm_packed_plain`; on the card :func:`packed_variant` picks the
    body, and ``.variants`` counts the launches by body."""
    if a_packed.device.type == "cpu":
        return gemm_packed_plain(a_packed, b_packed, m, n, c, alpha=alpha,
                                 beta=beta, layout_a=layout_a,
                                 layout_b=layout_b, out_dtype=out_dtype,
                                 epilogue=epilogue, bias=bias)
    if a_packed.device.type != "cuda":
        raise ValueError(f"gemm_packed runs on cuda or cpu; got "
                         f"{a_packed.device}")
    bm, bk, bn = _packed_geometry(a_packed, b_packed, layout_a, layout_b)
    dt = dtype_name(a_packed.dtype)
    if b_packed.dtype != a_packed.dtype or dt not in gt.IN_DTYPES:
        raise ValueError(f"kernel takes packed A and B of one dtype in "
                         f"{gt.IN_DTYPES}; got {a_packed.dtype} and "
                         f"{b_packed.dtype}")
    if not (a_packed.is_contiguous() and b_packed.is_contiguous()):
        raise ValueError("packed stacks must be contiguous")
    if b_packed.device != a_packed.device:
        raise ValueError(f"B on {b_packed.device}, A on {a_packed.device}")
    if not (0 < m <= a_packed.shape[0] * bm and 0 < n <= b_packed.shape[0] * bn):
        raise ValueError(f"m={m}, n={n} do not fit the packed stacks")
    out_dtype = out_dtype or (c.dtype if c is not None else a_packed.dtype)
    if dtype_name(out_dtype) not in gt.OUT_DTYPES:
        raise ValueError(f"kernel stores {gt.OUT_DTYPES}; got {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=a_packed.device)
    int_acc = acc_dtype_for(a_packed.dtype) == torch.int32
    c32, bias32 = gt.epilogue_operands(c, bias, m, n, int_acc,
                                       a_packed.device)
    kb = a_packed.shape[1]
    aligned = a_packed.data_ptr() % 16 == 0 and b_packed.data_ptr() % 16 == 0
    variant = packed_variant(a_packed.dtype, m, bm, bk, bn, layout_a, aligned)
    ws = None
    if variant == gt.FMA:
        fma, ws = gt.fma_args(m, kb * bk, n, acc_dtype_for(a_packed.dtype),
                              a_packed.device, item=a_packed.element_size(),
                              b_kfast=layout_b == "col", align=bk)
    elif variant == TC_STREAM:
        splits, chunk = tc_stream_split(kb, cdiv(n, bn))
        if splits > 1:
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=a_packed.device)
        fma = (0, 0, splits, chunk, None if ws is None else ws.data_ptr())
    else:
        fma = (0, 0, 1, 0, None)
    with torch.cuda.device(a_packed.device):
        stream = torch.cuda.current_stream(a_packed.device).cuda_stream
        rc = _packed_kernel()(
            a_packed.data_ptr(), int(layout_a == "col"), bm,
            b_packed.data_ptr(), int(layout_b == "col"), bn,
            a_packed.shape[1], bk, gt.DT[dt], m, n,
            None if bias32 is None else bias32.data_ptr(),
            None if c32 is None else c32.data_ptr(), n, float(alpha),
            float(beta if c is not None else 0.0), out.data_ptr(),
            gt.DT[dtype_name(out_dtype)],
            EPILOGUE_CODES[kernel_epilogue_name(epilogue)], variant, *fma,
            stream)
    if rc != 0:
        raise RuntimeError(f"gemm_packed launch failed: CUDA error {rc}")
    gemm_packed.launches += 1
    gemm_packed.variants[variant_name(variant, fma[0])] += 1
    return out


counts_launches(gemm_packed, PACKED_VARIANTS)
