"""PackedWeight — a weight matrix packed tile-major once, at load time.

Model weights are static across calls, so the paper's B-side packing is
hoisted out of every matmul and paid once. :meth:`PackedWeight.matmul`
declares a :class:`ContractionSpec` and runs through the one dispatch point;
the ``packed_weight`` lowering (:meth:`PackedWeight._matmul_impl`) runs the
pack-free-A kernel ``gemm_packed_fused_a``: A streams from its natural
layout, and bias + activation are applied in the kernel's store epilogue,
behind the per-tile dequant when the weight is quantized.

``quantize="int8"`` stores int8 tiles + per-tile f32 scales, ``"int4"``
nibble-packed tiles; a ``":col"`` suffix selects one scale per column of
tiles, applied once at store.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import contraction as ctr
from repro_torch.core.contraction import ContractionSpec
from repro_torch.core.dtypes import ROW_ALIGN, dtype_name
from repro_torch.core.epilogue import as_epilogue_spec
from repro_torch.core.planner import GemmPlan, plan_gemm
from repro_torch.core.tile_format import TileFormat, normalize_packed
from repro_torch.kernels.gemm_packed import gemm_packed_fused_a
from repro_torch.kernels.ref import pack_b_ref


def _parse_quantize(quantize: Optional[str]):
    """``quantize`` string -> (b_dtype, scale_granularity). Accepted: None,
    "int8", "int4", either optionally suffixed ":col"."""
    if quantize is None:
        return None, "tile"
    base, _, gran = quantize.partition(":")
    if base not in ("int8", "int4") or (gran and gran != "col"):
        raise ValueError(
            f"unsupported quantize={quantize!r} (accepted: 'int8', 'int4', "
            f"optionally suffixed ':col')")
    return base, (gran or "tile")


@dataclasses.dataclass
class PackedWeight:
    """A [K, N] weight stored tile-major per its plan's :class:`TileFormat`;
    ``scales`` is the dequant grid of a quantized format ([Nb, Kb], or [Nb]
    for ":col"), else None."""

    packed: torch.Tensor
    k: int
    n: int
    plan: GemmPlan
    scales: Optional[torch.Tensor] = None

    weight_kind = "packed"

    @functools.cached_property
    def fmt(self) -> TileFormat:
        return self.plan.b_format

    @classmethod
    def pack(cls, w: torch.Tensor, *, m_hint: int = 1024,
             plan: Optional[GemmPlan] = None,
             quantize: Optional[str] = None) -> "PackedWeight":
        """Pack ``w`` [K, N] with the torch packer, on ``w``'s device."""
        assert w.dim() == 2, tuple(w.shape)
        k, n = w.shape
        b_dtype, gran = _parse_quantize(quantize)
        plan = plan or plan_gemm(m_hint, k, n, dtype_name(w.dtype),
                                 b_dtype=b_dtype, scale_granularity=gran)
        if quantize is not None and not plan.b_format.is_quantized:
            raise ValueError(f"quantize={quantize!r} needs a plan with "
                             f"b_dtype set (got {plan})")
        packed, scales = normalize_packed(pack_b_ref(w, plan.b_format),
                                          plan.b_format)
        return cls(packed=packed, k=k, n=n, plan=plan, scales=scales)

    def _clamp_bm(self, rows: int) -> int:
        # The packed buffer does not depend on bm: clamp the m-block to the
        # runtime row count, so a 4-row decode step is not padded to 64.
        return min(self.plan.bm, -(-max(rows, 1) // ROW_ALIGN) * ROW_ALIGN)

    def _check_k(self, k_got: int) -> None:
        if k_got != self.k:
            raise ValueError(f"contraction mismatch: a has K={k_got}, weight "
                             f"was packed with K={self.k}")

    def matmul(self, a: torch.Tensor, *, bias=None, epilogue="none",
               out_dtype=None) -> torch.Tensor:
        """epilogue(a[M,K] @ W + bias) through the one dispatch point."""
        from repro_torch.core.gemm import contract  # gemm imports this module
        spec = ContractionSpec.dense(
            a.shape[0], a.shape[1], self.n, a.dtype, w=self,
            epilogue=as_epilogue_spec(epilogue), bias=bias is not None,
            out_dtype=out_dtype)
        return contract(spec, a, self, bias=bias)

    def _matmul_impl(self, a: torch.Tensor, *, bias, epilogue: str,
                     out_dtype) -> torch.Tensor:
        """The ``packed_weight`` lowering body: the fused-A kernel (its
        plain torch version for CPU tensors)."""
        self._check_k(a.shape[1])
        return gemm_packed_fused_a(
            a, self.packed, self.n, bm=self._clamp_bm(a.shape[0]),
            layout_b=self.plan.layout_b, b_scales=self.scales, bias=bias,
            epilogue=epilogue, b_format=self.fmt,
            out_dtype=out_dtype or a.dtype)


def _run_packed_weight(spec, a, w, *, bias=None):
    return w._matmul_impl(a, bias=bias, epilogue=spec.epilogue.kernel_name,
                          out_dtype=spec.resolved_out_dtype(a))


ctr.register_lowering(
    "packed_weight", "dense",
    supports=lambda spec: spec.weight == "packed",
    cost=lambda spec: 0.0,   # load-time packing already paid: always the pick
    run=_run_packed_weight)
