"""K4 — ``flash_attention``: blocked online-softmax attention over q
[B, Sq, H, D] and k / v [B, Skv, Hkv, D] (GQA: query head ``h`` reads KV head
``h // (H / Hkv)``), with causal, sliding-window and key-tail masks, queries
right-aligned with the keys. The CUDA kernel is ``csrc/flash_attention.cu``;
its plain torch version :func:`flash_attention_plain` sits beside it.

A row that sees no key (``Sq > Skv`` under causal masking, or a window that
leaves nothing) comes out 0, as in the reference kernel, where the softmax
oracle ``ref.attention_ref`` gives NaN.

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
from repro_torch.kernels.ref import attention_mask

DT = {"float32": 0, "bfloat16": 1, "float16": 2}  # enum DType of the source
MAX_HEAD_DIM = 256
MAX_KV_HEADS = 65535  # B * Hkv rides the kernel's grid y axis (checked here only)
# Largest f32 temporary of the plain version, in elements (1 GiB): scores of
# a chunk of queries and batch rows, or its K / V rows widened to f32.
PLAIN_CHUNK_ELEMS = 1 << 28

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # q, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # k, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # v, strides
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # out, dt, B, Sq
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,                    # Skv, H, Hkv, D
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,             # causal, has_w, w, scale
    ctypes.c_void_p,                                                           # stream
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,D], k/v [B,Skv,Hkv,D] -> [B,Sq,H,D] in q's dtype; ``scale``
    defaults to 1/sqrt(D) and multiplies the f32 scores. The kernel chooses
    its own tiles. On the CPU this is :func:`flash_attention_plain`."""
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
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], out.data_ptr(), DT[dt], b, sq, skv,
            h, hkv, d, int(bool(causal)), int(window is not None),
            0 if window is None else int(window), _scale(scale, d), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
