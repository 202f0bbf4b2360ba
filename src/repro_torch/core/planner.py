"""Block-size planner for Hopper — the paper's constraint system (tile sizes
from the memory hierarchy and the matrix unit's shape) solved for an H100.

On the card the fast memory is a block's shared memory (227 KB of the SM's
256 KB) and the register file, the matrix unit takes 16-row tiles (mma.sync
m16n8k16; wgmma 64 rows per warpgroup) and a 32-byte deep k-step, and the
parallelism is 132 SMs that each want one or more blocks. The constraints:

  (C1) one block's staged slices fit shared memory:
       KC * (BM + 1 + BN + 1) * acc_itemsize <= 227 KB (the fused-A
       kernel stages KC-deep slices of A and B widened to its accumulator);
  (C2) tiles align to the matrix unit: bm, bn multiples of 16, bk a
       multiple of max(16, 32 bytes of B's element type);
  (C3) enough blocks: the packed format's bn is fixed at pack time and the
       kernel may split a tile into narrower column chunks, so bn is the
       WIDEST chunk the kernel takes (64). A decode step (M of a few rows)
       on an N = 2048 projection then has 32 tiles that the kernel splits
       into 128 column blocks, against 132 SMs — where a TPU-sized bn of 512
       would have left 4 tiles.

bk is as deep as the problem allows up to 128: fewer per-tile scale
multiplies for quantized formats and longer contiguous B runs.

The strategy choice (:func:`choose_strategy`, :func:`should_pack`) keeps
the reference's two conditions for per-call packing of B, solved with the
card's numbers: (a) more than one m-block (``m > max_bm``: otherwise each B
tile is read once and a copy buys nothing), and (b) B larger than a small
slice of a block's fast memory (``k * n * b_item > smem_per_block // 32``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import dtypes as mdt
from repro_torch.core.dtypes import ROW_ALIGN
from repro_torch.core.tile_format import ScaleSpec, TileFormat, is_dequant_pair
# The card's figures, the planner's among them, have one source.
from repro_torch.roofline.hw import H100, HopperTarget  # noqa: F401


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    bm: int
    bk: int
    bn: int
    dtype: str
    acc_dtype: str
    layout_a: str = "row"
    layout_b: str = "row"
    b_dtype: Optional[str] = None   # B element dtype when it differs (int8/int4)
    b_scale: str = "tile"           # quantized scale granularity: tile | col

    @property
    def b_format(self) -> TileFormat:
        """The packed-B tile format this plan implies."""
        bdt = self.b_dtype or self.dtype
        scale = (ScaleSpec(granularity=self.b_scale)
                 if is_dequant_pair(self.dtype, bdt) else None)
        return TileFormat(bk=self.bk, bn=self.bn, layout=self.layout_b,
                          dtype=bdt, scale=scale)

    def kwargs(self) -> dict:
        return dict(bm=self.bm, bk=self.bk, bn=self.bn)

    def smem_working_set(self, target: HopperTarget = H100,
                         n_b_streams: int = 1) -> int:
        """(C1)'s left side: the staged A slice and ``n_b_streams`` B
        slices (the silu-gate pair stages a second one), widened to the
        accumulator type."""
        acc_item = mdt.torch_dtype(self.acc_dtype).itemsize  # f32 or i32
        return target.kc * (self.bm + 1 + n_b_streams * (target.max_bn + 1)
                            ) * acc_item

    def validate(self, target: HopperTarget = H100,
                 n_b_streams: int = 1) -> None:
        rows, kmult = mdt.alignment(self.b_dtype or self.dtype)
        if self.smem_working_set(target, n_b_streams) > target.smem_per_block:
            raise ValueError(f"plan {self} exceeds shared memory")
        for name, val, mult in (("bm", self.bm, rows), ("bn", self.bn, rows),
                                ("bk", self.bk, kmult)):
            if val % mult:
                raise ValueError(f"{name}={val} not aligned to {mult}")


def _align_up(x: int, mult: int) -> int:
    return max(-(-x // mult) * mult, mult)


def plan_gemm(m: int, k: int, n: int, dtype="float32", *,
              b_dtype: Optional[str] = None,
              target: HopperTarget = H100,
              layout_b: str = "row",
              scale_granularity: str = "tile") -> GemmPlan:
    """Solve the Hopper constraint system for one [M, K] x [K, N] problem."""
    d = mdt.info(mdt.dtype_name(dtype))
    rows, kmult = mdt.alignment(b_dtype or d.name)
    bm = min(target.max_bm, _align_up(m, rows))
    bn = min(target.max_bn, _align_up(n, rows))
    bk = min(target.max_bk // kmult * kmult or kmult, _align_up(k, kmult))
    plan = GemmPlan(bm=bm, bk=bk, bn=bn, dtype=d.name, acc_dtype=d.acc_dtype,
                    layout_b=layout_b, b_dtype=b_dtype,
                    b_scale=scale_granularity)
    plan.validate(target)
    return plan


def plan_grouped_gemm(e: int, m: int, k: int, n: int, dtype="float32", *,
                      b_dtype: Optional[str] = None,
                      target: HopperTarget = H100,
                      n_b_streams: int = 1,
                      layout_b: str = "row",
                      scale_granularity: str = "tile") -> GemmPlan:
    """Plan for the grouped kernel: one expert's [m, k, n] problem at a time.

    The expert (segment) axis is a grid axis of its own, so the per-expert
    tile constraints are exactly :func:`plan_gemm`'s. ``n_b_streams=2``
    checks the silu-gate pair's second staged B slice against (C1) — on
    an H100 the largest blocks stage 25 KB of the 227 KB, so the plan is
    :func:`plan_gemm`'s, and the gate and up stacks of one layer get the
    same plan and pack alike. ``e`` takes no part in the tiles (every
    expert packs with the same format)."""
    del e
    plan = plan_gemm(m, k, n, dtype, b_dtype=b_dtype, target=target,
                     layout_b=layout_b, scale_granularity=scale_granularity)
    plan.validate(target, n_b_streams)
    return plan


def should_pack(m: int, k: int, n: int, dtype="float32", *,
                b_dtype: Optional[str] = None, target: HopperTarget = H100,
                group: int = 1, occupancy: float = 1.0) -> bool:
    """Whether a per-call tile-major copy of B, streamed against A in its
    own layout, pays for itself: (a) more than one m-block, ``m >
    max_bm``, and (b) B's bytes (at B's own dtype) beyond
    ``smem_per_block // 32``. ``group=E`` (the grouped kernel over a
    stacked [E, K, N] B, ``m`` the per-expert rows): (a) becomes at least
    one 16-row block of EXPECTED rows, ``m * occupancy > 16``, and (b) is
    tested against the whole stack."""
    item = mdt.info(mdt.dtype_name(dtype)).itemsize
    b_item = mdt.info(mdt.dtype_name(b_dtype)).itemsize if b_dtype else item
    if group > 1:
        m_expected = m * min(max(occupancy, 0.0), 1.0)
        return (m_expected > ROW_ALIGN
                and group * k * n * b_item > target.smem_per_block // 32)
    return m > target.max_bm and k * n * b_item > target.smem_per_block // 32


def choose_strategy(m: int, k: int, n: int, dtype="float32", *,
                    b_dtype: Optional[str] = None,
                    target: HopperTarget = H100,
                    weights_prepacked: bool = False) -> str:
    """The kernel-target pick for a raw-weight dense GEMM: ``tiling`` (K7
    on the strided operands) below the crossover, ``tiling_packing_fused``
    (K5 packs B, K1 streams A pack-free) above it; load-time-packed weights
    always take the fused kernel."""
    if weights_prepacked or should_pack(m, k, n, dtype, b_dtype=b_dtype,
                                        target=target):
        return "tiling_packing_fused"
    return "tiling"


def choose_grouped_strategy(e: int, m: int, k: int, n: int, dtype="float32",
                            *, b_dtype: Optional[str] = None,
                            target: HopperTarget = H100,
                            counts_known: bool = False,
                            occupancy: float = 1.0) -> str:
    """The kernel-target pick for a raw expert stack: above the grouped
    crossover the stack is packed per call (K5) for the grouped kernel —
    ``grouped_packed_ragged`` (K2) when counts come with the call, else
    ``grouped_packed`` (K3) — below it one batched einsum."""
    if should_pack(m, k, n, dtype, b_dtype=b_dtype, target=target, group=e,
                   occupancy=occupancy):
        return "grouped_packed_ragged" if counts_known else "grouped_packed"
    return "grouped_einsum"
