"""The paper's own experimental grid (SGEMM sizes and strategies), the
port's copy of ``repro/configs/paper_gemm.py``.

Mirrors §4 of Kuzma et al.: small / medium / large square SGEMM problem sizes
and the six code-generation strategies compared in Figures 4-10.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Paper §4: small (Fig 4/7), medium (Fig 5/8), large (Fig 6/9) square SGEMMs.
SMALL_SIZES: Tuple[int, ...] = (16, 32, 64)
MEDIUM_SIZES: Tuple[int, ...] = (128, 256, 512)
LARGE_SIZES: Tuple[int, ...] = (1024, 2048, 4096)

# §4.1.3: register-tile parameters used in the paper's evaluation.
PAPER_TILE_GENERIC = dict(mr=16, nr=4, kr=64)     # Intel/AMD/POWER9
PAPER_TILE_MMA = dict(mr=16, nr=8, kr=128)        # POWER10 MMA

# The paper's headline claims.
PAPER_CLAIMS = {
    "tiling_beats_pluto_small": "Tiling up to 22x faster than PLuTo (small, Intel)",
    "packing_wins_large": "Tiling+Packing is the best strategy for large GEMM",
    "tiling_wins_small": "Tiling (no packing) is the best strategy for small GEMM",
    "mma_vs_vsx": "Matrix-engine lowering >2.6x the generic vector lowering",
    "blas_fraction": "96% of BLAS peak for large SGEMM on the matrix engine",
}


@dataclasses.dataclass(frozen=True)
class GemmProblem:
    m: int
    n: int
    k: int
    dtype: str = "float32"
    alpha: float = 1.0
    beta: float = 1.0

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k


def square(n: int, dtype: str = "float32") -> GemmProblem:
    return GemmProblem(m=n, n=n, k=n, dtype=dtype)
