"""SYR2K via the layered strategy — the paper's §5.1 extension, in plain
torch (the reference is plain jnp over its packers and reaches no Pallas
kernel, so this module has no CUDA kernel either).

SYR2K computes the lower (or upper) triangle of
    C <- alpha * A @ B^T + alpha * B @ A^T + beta * C,      A,B: [N,K]
C symmetric. Per the paper: "high performance implementations partition the
matrix C into blocks and use a pair of GEMM operations to update each block",
with packed normal AND transposed copies of A and B (two pack calls each —
Algorithm 1 lines 3/5 doubled), reusing the same tiling/packing machinery.

``syr2k_layered`` walks only the on/below-diagonal blocks (half the GEMM
work, the point of the triangular kernel) and issues two packed block
products per block, exactly as §5.1 describes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.planner import GemmPlan, plan_gemm
from repro_torch.core.tile_format import cdiv
from repro_torch.kernels import ref as kref
from repro_torch.kernels.common import pad2d


def _triangle(x: torch.Tensor, uplo: str) -> torch.Tensor:
    return torch.tril(x) if uplo == "lower" else torch.triu(x)


def syr2k_ref(a: torch.Tensor, b: torch.Tensor,
              c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
              beta: float = 0.0, uplo: str = "lower") -> torch.Tensor:
    """Dense oracle (computes the full product in f32, returns one
    triangle)."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    out = alpha * (a32 @ b32.T + b32 @ a32.T)
    if c is not None and beta != 0:
        out = out + beta * c.to(torch.float32)
    return _triangle(out, uplo).to(a.dtype)


def syr2k_layered(a: torch.Tensor, b: torch.Tensor,
                  c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
                  beta: float = 0.0, uplo: str = "lower",
                  plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Blocked SYR2K: per-block pair of packed products, triangle blocks
    only."""
    n, k = a.shape
    if tuple(b.shape) != (n, k):
        raise ValueError(f"A {tuple(a.shape)} and B {tuple(b.shape)} differ")
    plan = plan or plan_gemm(n, k, n, a.dtype)
    bm = bn = min(plan.bm, plan.bn)  # square C blocks for the triangle walk
    bk = plan.bk

    # Macro level: pack normal and transposed copies (paper: "two calls for
    # packing matrix B and two calls for packing matrix A"). Row layouts: the
    # micro contraction below consumes [bm,bk]x[bk,bn] tiles directly.
    a_p = kref.pack_a_ref(a, bm, bk, "row").to(torch.float32)      # A   [Nb,Kb,bm,bk]
    bt_p = kref.pack_b_ref(b.T, bk, bn, "row").to(torch.float32)   # B^T [Nb,Kb,bk,bn]
    b_p = kref.pack_a_ref(b, bm, bk, "row").to(torch.float32)      # B
    at_p = kref.pack_b_ref(a.T, bk, bn, "row").to(torch.float32)   # A^T

    nb = cdiv(n, bm)
    cp = pad2d(c if c is not None else torch.zeros((n, n), dtype=a.dtype,
                                                   device=a.device), bm, bn)
    cp = cp.to(torch.float32)
    out = torch.zeros_like(cp)
    for i in range(nb):
        for j in (range(i + 1) if uplo == "lower" else range(i, nb)):
            # two matrix-multiply calls per C block (paper §5.1)
            ab = torch.einsum("kab,kbc->ac", a_p[i], bt_p[j])
            ba = torch.einsum("kab,kbc->ac", b_p[i], at_p[j])
            blk = alpha * (ab + ba)
            rows, cols = slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn)
            if beta != 0:
                blk = blk + beta * cp[rows, cols]
            out[rows, cols] = blk
    return _triangle(out[:n, :n], uplo).to(a.dtype)


def syr2k_flops(n: int, k: int) -> int:
    """Useful FLOPs: 2 products over the triangle = 2 * n(n+1)/2 * k * 2."""
    return 2 * n * (n + 1) * k
