"""K4 — ``flash_attention``: blocked online-softmax attention over q
[B, Sq, H, D] and k / v [B, Skv, Hkv, D] (GQA: query head ``h`` reads KV head
``h // (H / Hkv)``), with causal, sliding-window and key-tail masks, queries
right-aligned with the keys. The CUDA kernel is ``csrc/flash_attention.cu``;
its plain torch version :func:`flash_attention_plain` sits beside it.

A row that sees no key (``Sq > Skv`` under causal masking, or a window that
leaves nothing) comes out 0, as in the reference kernel, where the softmax
oracle ``ref.attention_ref`` gives NaN.

The kernel has four bodies, and :func:`attention_body` picks one a call:

* ``stream`` (decode): bf16 / f16 that TMA can read
  (:func:`attention_tma_aligned`), D 64 or 128, at most ``STREAM_ROWS``
  (query, head) rows per (batch, KV head): K / V stream through a TMA ring,
  every warp takes its share of the keys on mma.sync;
* ``wgmma`` (prefill): the same operands with more rows: TMA + wgmma,
  128 queries of one head a block, P kept in registers for P V;
* ``mma_general``: any other bf16 / f16 (D not 64 / 128, a base or stride
  off 16 bytes): mma.sync from padded shared rows;
* ``f32``: full f32 on the CUDA cores.

``flash_attention.variants`` counts the launches by body.

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
from repro_torch.kernels.common import cdiv
from repro_torch.kernels.ref import attention_mask

DT = {"float32": 0, "bfloat16": 1, "float16": 2}  # enum DType of the source
MAX_HEAD_DIM = 256
MAX_KV_HEADS = 65535  # B * Hkv rides the kernel's grid y axis (checked here only)
# Largest f32 temporary of the plain version, in elements (1 GiB): scores of
# a chunk of queries and batch rows, or its K / V rows widened to f32.
PLAIN_CHUNK_ELEMS = 1 << 28
# K4's bodies by name and their codes in the source (enum FlashBody); the
# names are the ``.variants`` keys.
BODY = {"f32": 0, "mma_general": 1, "stream": 2, "wgmma": 3}
ATTENTION_BODIES = tuple(BODY)
STREAM_ROWS = 16          # the stream body's rows per (batch, KV head): one m16 tile
TMA_HEAD_DIMS = (64, 128)  # head dims of the TMA bodies (one or two 64-column boxes)
# Key tiles of the TMA bodies (WQ_BKV, ST_BKV) and the wgmma body's row tile
# (WQ_ROWS): the geometry that :func:`tile_class` mirrors.
WGMMA_ROWS, WGMMA_KEYS, STREAM_KEYS = 128, 128, 64

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # q, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # k, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # v, strides
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # out, dt, B, Sq
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,                    # Skv, H, Hkv, D
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,             # causal, has_w, w, scale
    ctypes.c_int, ctypes.c_void_p,                                             # body, stream
]


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _geometry(q, k, v):
    """(B, Sq, H, D, Skv, Hkv) after checking that the shapes fit."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q [B,Sq,H,D], k and v [B,Skv,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    bk, skv, hkv, dk = k.shape
    if bk != b or dk != d or hkv == 0 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"match (batch, head dim, H a multiple of Hkv)")
    return b, sq, h, d, skv, hkv


def _scale(scale, d) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(d))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain torch version: f32 scores and weights, exact softmax, a
    row that sees no key 0. Chunked over queries and batch rows, each query
    chunk against only the keys its causal / window range can see, so that
    no f32 temporary exceeds ``PLAIN_CHUNK_ELEMS`` elements at long
    context. GQA by broadcasting, with no repeat."""
    b, sq, h, d, skv, hkv = _geometry(q, k, v)
    group, scale, dev = h // hkv, _scale(scale, d), q.device
    out = torch.zeros(q.shape, dtype=q.dtype, device=dev)
    cq = max(1, min(sq, PLAIN_CHUNK_ELEMS // max(1, h * skv)))
    for i0 in range(0, sq, cq):
        i1 = min(sq, i0 + cq)
        q_pos = torch.arange(i0, i1, device=dev) + (skv - sq)
        k_lo, k_hi = 0, skv                      # the chunk's keys [k_lo, k_hi)
        if causal:
            k_hi = min(k_hi, i1 + skv - sq)    # last row's position + 1
        if window is not None:
            k_lo = max(k_lo, i0 + skv - sq - window + 1)
        if k_hi <= k_lo:
            continue                             # no row sees a key: 0
        nk = k_hi - k_lo
        mask = attention_mask(q_pos, torch.arange(k_lo, k_hi, device=dev),
                              causal=causal, window=window)
        nb = max(1, min(b, PLAIN_CHUNK_ELEMS // max(h * (i1 - i0) * nk,
                                                    hkv * nk * d)))
        for b0 in range(0, b, nb):
            b1 = min(b, b0 + nb)
            qc = q[b0:b1, i0:i1].to(torch.float32).reshape(
                b1 - b0, i1 - i0, hkv, group, d).permute(0, 2, 3, 1, 4)
            kc = k[b0:b1, k_lo:k_hi].to(torch.float32).permute(0, 2, 1, 3)
            vc = v[b0:b1, k_lo:k_hi].to(torch.float32).permute(0, 2, 1, 3)
            s = torch.matmul(qc, kc[:, :, None].transpose(-1, -2)) * scale
            s = s.masked_fill(~mask, float("-inf"))  # [nb, Hkv, group, cq, nk]
            m = s.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            o = torch.matmul(p, vc[:, :, None]) / torch.where(
                l == 0, torch.ones_like(l), l)
            out[b0:b1, i0:i1] = o.permute(0, 3, 1, 2, 4).reshape(
                b1 - b0, i1 - i0, h, d).to(q.dtype)
    return out


def attention_strides(t: torch.Tensor) -> tuple:
    """(sb, ss, sh): the batch, sequence and head element strides of q, k
    or v as the kernel takes them. A dim of extent 1 is never stepped, so
    torch leaves its stride free; it is replaced by the span of the dims
    inside it, rounded up to 16 bytes, so that a ``[B, 1, H, D]`` decode q
    (or a single head, or batch 1) never looks misaligned."""
    b, s, h, d = t.shape
    sb, ss, sh, _ = t.stride()
    per16 = max(1, 16 // t.element_size())

    def span(elems):
        return cdiv(max(1, elems), per16) * per16
    if h == 1:
        sh = span(d)
    if s == 1:
        ss = span(h * sh)
    if b == 1:
        sb = span(s * ss)
    return sb, ss, sh


def attention_tma_aligned(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> bool:
    """Whether TMA can read q, k and v as they lie: each has elements, a
    16-byte aligned base, a unit last stride, and batch / sequence / head
    strides (after :func:`attention_strides`) that are positive multiples
    of 16 bytes."""
    for t in (q, k, v):
        if t.numel() == 0 or t.stride(-1) != 1:
            return False
        per16 = max(1, 16 // t.element_size())
        if t.data_ptr() % 16 or any(st <= 0 or st % per16
                                    for st in attention_strides(t)):
            return False
    return True


def attention_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None) -> str:
    """K4's body for these operands (the masks do not change it): f32 takes
    ``f32``; bf16 / f16 that :func:`attention_tma_aligned` passes, with D
    in ``TMA_HEAD_DIMS``, take ``stream`` up to ``STREAM_ROWS`` rows
    (Sq * H / Hkv) per (batch, KV head) and ``wgmma`` above; any other bf16
    / f16 takes ``mma_general``. D = 256 is not on a TMA body: its O
    accumulator alone would be 128 registers a thread of the wgmma body."""
    del causal, window
    if dtype_name(q.dtype) == "float32":
        return "f32"
    _, sq, h, d = q.shape
    if d in TMA_HEAD_DIMS and attention_tma_aligned(q, k, v):
        return "stream" if sq * (h // k.shape[2]) <= STREAM_ROWS else "wgmma"
    return "mma_general"


def tile_class(sq: int, skv: int, causal: bool, window: Optional[int],
               i_lo: int, i_hi: int, j: int, bkv: int) -> str:
    """The class of key tile ``j`` (keys ``[j * bkv, (j + 1) * bkv)``)
    against the live queries ``[i_lo, i_hi]`` of a row tile, as the CUDA
    source decides it (``visible_tiles`` and ``interior_tile``):
    ``"invisible"`` (not loaded), ``"interior"`` (every row sees every key:
    no mask) or ``"edge"`` (masked key by key)."""
    shift = skv - sq
    qp_lo, qp_hi = i_lo + shift, i_hi + shift

    def sees(q_pos, k_pos):
        return (k_pos < skv and (not causal or q_pos >= k_pos)
                and (window is None or q_pos - k_pos < window))
    k_lo, k_hi = 0, skv - 1
    if causal:
        k_hi = min(k_hi, qp_hi)
    if window is not None:
        k_lo = max(k_lo, qp_lo - window + 1)
    if k_hi < k_lo or not k_lo // bkv <= j <= k_hi // bkv:
        return "invisible"
    k0 = j * bkv
    if sees(qp_lo, k0 + bkv - 1) and sees(qp_hi, k0):
        return "interior"
    return "edge"


def launch_args(q, k, v, out, *, causal, window, scale, stream) -> tuple:
    """The C entry point's argument tuple for q, k, v (the wrapper has
    checked them) and the output ``out``, and the body it runs:
    ``(args, body)``. Strides of extent-1 dims are replaced
    (:func:`attention_strides`)."""
    b, sq, h, d, skv, hkv = _geometry(q, k, v)
    body = attention_body(q, k, v, causal, window)
    return (q.data_ptr(), *attention_strides(q), k.data_ptr(),
            *attention_strides(k), v.data_ptr(), *attention_strides(v),
            out.data_ptr(), DT[dtype_name(q.dtype)], b, sq, skv, h, hkv, d,
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), _scale(scale, d),
            BODY[body], stream), body


def _launch(q, k, v, *, causal, window, scale, stream) -> torch.Tensor:
    """Allocate the output, launch the kernel on ``stream`` and count the
    launch by body (an empty output launches nothing). A tensor whose last
    stride is not 1 is copied first."""
    b, sq, h, d, _, _ = _geometry(q, k, v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    args, body = launch_args(q, k, v, out, causal=causal, window=window,
                             scale=scale, stream=stream)
    rc = _kernel()(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed ({body}): CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    flash_attention.variants[body] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,Hkv,D] -> [B,Sq,H,D] in q's dtype; ``scale``
    defaults to 1/sqrt(D) and multiplies the f32 scores. The kernel's body
    is :func:`attention_body`'s. On the CPU this is
    :func:`flash_attention_plain`."""
    b, sq, h, d, skv, hkv = _geometry(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu; got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    dt = dtype_name(q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype or dt not in DT:
        raise ValueError(f"kernel takes q, k, v of one dtype in {tuple(DT)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head dims up to {MAX_HEAD_DIM}; got {d}")
    if b * hkv > MAX_KV_HEADS:
        raise ValueError(f"B * Hkv = {b * hkv} exceeds {MAX_KV_HEADS}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return _launch(q, k, v, causal=causal, window=window, scale=scale,
                       stream=stream)


counts_launches(flash_attention, ATTENTION_BODIES)
