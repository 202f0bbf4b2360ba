"""The kernels' public wrappers: the port's counterpart of the reference's
jit'd ``repro.kernels.ops``, under the same names. Each wrapper launches the
port's CUDA kernel(s) on CUDA tensors and runs their plain torch versions on
CPU tensors:

  tiled_matmul           K7 ``gemm_tiled``
  packed_matmul          K5 ``pack_a`` + ``pack_b``, then K6 ``gemm_packed``
  packed_matmul_fused    K5 ``pack_b``, then K1 ``gemm_packed_fused_a``
  grouped_matmul_packed  K5 ``pack_b_grouped`` (twice with ``b2``), then K3
                         ``gemm_grouped_packed``
  vsx_matmul             K8 ``matmul_vsx_like``
  attention              K4 ``flash_attention``
  pack_a_op / pack_b_op / pack_b_grouped_op   K5

PyTorch runs eagerly, so there is no ``jit`` here. Keywords of the reference
that the port's kernels would ignore are dropped rather than accepted:
``interpret`` everywhere; ``bk`` and ``bn`` of ``tiled_matmul`` and
``vsx_matmul`` (K7 and K8 stage fixed k and n blocks); ``bq`` and ``bkv`` of
``attention`` (K4 chooses its own tiles). ``bm`` stays: it is K7's and K8's
m-tile, the pack tile of ``packed_matmul``, and K1's and K3's m-block, which
takes 16, 32, 48 or 64 (default 64 where the reference's is 128).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm_grouped import gemm_grouped_packed
from repro_torch.kernels.gemm_packed import gemm_packed, gemm_packed_fused_a
from repro_torch.kernels.gemm_tiled import gemm_tiled
from repro_torch.kernels.gemm_vsx_like import matmul_vsx_like
from repro_torch.kernels.pack import pack_a, pack_b, pack_b_grouped

__all__ = [
    "tiled_matmul", "packed_matmul", "packed_matmul_fused",
    "grouped_matmul_packed", "vsx_matmul", "attention", "pack_a_op",
    "pack_b_op", "pack_b_grouped_op",
]


def tiled_matmul(a, b, c=None, *, bm=64, alpha=1.0, beta=0.0, out_dtype=None):
    return gemm_tiled(a, b, c, alpha=alpha, beta=beta, bm=bm,
                      out_dtype=out_dtype)


def packed_matmul(a, b, c=None, *, bm=128, bk=128, bn=128, layout_a="row",
                  layout_b="row", alpha=1.0, beta=0.0, out_dtype=None):
    """Full Tiling+Packing pipeline: pack both operands, then packed GEMM."""
    m, n = a.shape[0], b.shape[1]
    ap = pack_a(a, bm, bk, layout=layout_a)
    bp = pack_b(b, bk, bn, layout=layout_b)
    return gemm_packed(ap, bp, m, n, c, alpha=alpha, beta=beta,
                       layout_a=layout_a, layout_b=layout_b,
                       out_dtype=out_dtype)


def packed_matmul_fused(a, b, c=None, *, bias=None, bm=64, bk=128, bn=128,
                        layout_b="row", alpha=1.0, beta=0.0, out_dtype=None,
                        epilogue="none"):
    """Fused-A pipeline: pack B tile-major, stream A pack-free from [M,K]
    (the per-call analogue of serving's load-time-packed weights)."""
    bp = pack_b(b, bk, bn, layout=layout_b)
    return gemm_packed_fused_a(a, bp, b.shape[1], c, bm=bm, alpha=alpha,
                               beta=beta, layout_b=layout_b,
                               out_dtype=out_dtype, epilogue=epilogue,
                               bias=bias)


def grouped_matmul_packed(a, b, *, b2=None, bias=None, bm=64, bk=128, bn=128,
                          layout_b="row", out_dtype=None, epilogue="none"):
    """Per-call grouped pipeline: pack the expert stack (and ``b2`` for the
    ``"silu_gate"`` pair), then the grouped kernel."""
    n = b.shape[2]
    bp = pack_b_grouped(b, bk, bn, layout=layout_b)
    b2p = (pack_b_grouped(b2, bk, bn, layout=layout_b)
           if b2 is not None else None)
    return gemm_grouped_packed(a, bp, n, b2_packed=b2p, bm=bm,
                               layout_b=layout_b, out_dtype=out_dtype,
                               epilogue=epilogue, bias=bias)


def vsx_matmul(a, b, *, bm=64, out_dtype=None):
    return matmul_vsx_like(a, b, bm=bm, out_dtype=out_dtype)


def attention(q, k, v, *, causal=True, window=None, scale=None):
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


pack_a_op = pack_a
pack_b_op = pack_b
pack_b_grouped_op = pack_b_grouped
