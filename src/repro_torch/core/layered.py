"""LayeredGemm, PackedWeight / GroupedPackedWeight — the layered GEMM
planned once, and weights packed tile-major once, at load time.

:class:`LayeredGemm` is the paper's layered GEMM as one object: the plan is
solved at construction and every call runs the chosen strategy with it.

Model weights are static across calls, so the paper's B-side packing is
hoisted out of every matmul and paid once. :meth:`PackedWeight.matmul`
declares a dense :class:`ContractionSpec` and runs through the one dispatch
point; the ``packed_weight`` lowering (:meth:`PackedWeight._matmul_impl`)
runs the pack-free-A kernel ``gemm_packed_fused_a``: A streams from its
natural layout, and bias + activation are applied in the kernel's store
epilogue, behind the per-tile dequant when the weight is quantized.
:class:`GroupedPackedWeight` is the same for a stack of expert matrices
[E, K, N], lowered by ``grouped_packed_weight`` to the grouped kernels
``gemm_grouped_packed_ragged`` (with valid-row counts) and
``gemm_grouped_packed`` (without).

``quantize="int8"`` stores int8 tiles + per-tile f32 scales, ``"int4"``
nibble-packed tiles; a ``":col"`` suffix selects one scale per column of
tiles, applied once at store.

The lowering bodies hold the reference's fault sites: ``kernel_compile``
before the kernel, ``scale_grid`` on the scale grid it reads, ``kernel_run``
after it. ``GroupedPackedWeight.matmul`` / ``silu_gate`` run their chosen
lowering through the guarded runner (``contraction.run_guarded``), after
their contract checks, so a fallback chain never swallows a contract
violation.
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
from repro_torch.core.planner import (GemmPlan, choose_strategy, plan_gemm,
                                      plan_grouped_gemm)
from repro_torch.core.tile_format import TileFormat, normalize_packed
from repro_torch.kernels.gemm_grouped import (gemm_grouped_packed,
                                              gemm_grouped_packed_ragged)
from repro_torch.kernels.gemm_packed import gemm_packed_fused_a
from repro_torch.kernels.pack import pack_b, pack_b_grouped
from repro_torch.testing import faults


@dataclasses.dataclass
class LayeredGemm:
    """Plan once, run many: the layered GEMM for one fixed [M, K] x [K, N]
    signature. ``__post_init__`` solves the plan (``plan_gemm``) and, where
    ``strategy`` is None, takes the planner's kernel pick
    (``planner.choose_strategy``); each call runs ``core.strategy.run``
    with that plan and the stored epilogue. It runs where its operands lie:
    the kernels' plain versions on the CPU, the kernels on the card, where
    a kernel's failure raises. The reference's ``backend`` field has no
    counterpart."""

    m: int
    k: int
    n: int
    dtype: str = "float32"
    strategy: Optional[str] = None
    epilogue: str = "none"
    plan: Optional[GemmPlan] = None

    def __post_init__(self):
        self.plan = self.plan or plan_gemm(self.m, self.k, self.n, self.dtype)
        if self.strategy is None:
            self.strategy = choose_strategy(self.m, self.k, self.n,
                                            self.dtype)

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
                 beta: float = 0.0, bias: Optional[torch.Tensor] = None,
                 out_dtype=None) -> torch.Tensor:
        assert tuple(a.shape) == (self.m, self.k) and \
            tuple(b.shape) == (self.k, self.n), (
                tuple(a.shape), tuple(b.shape), (self.m, self.k, self.n))
        from repro_torch.core import strategy  # strategy imports the kernels
        return strategy.run(self.strategy, a, b, c, alpha=alpha, beta=beta,
                            plan=self.plan, out_dtype=out_dtype, bias=bias,
                            epilogue=self.epilogue)


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


class _PackedCommon:
    """What both packed-weight kinds share: the declared weight kind, the
    format of the plan, the packer and the runtime m-block clamp."""

    weight_kind = "packed"

    @functools.cached_property
    def fmt(self) -> TileFormat:
        return self.plan.b_format

    @staticmethod
    def _pack_tiles(w: torch.Tensor, plan: GemmPlan, quantize):
        """``w`` [K, N] or [E, K, N] -> (packed, scales-or-None) per
        ``plan``, by the pack kernel K5 (its plain version on the CPU)."""
        if quantize is not None and not plan.b_format.is_quantized:
            raise ValueError(f"quantize={quantize!r} needs a plan with "
                             f"b_dtype set (got {plan})")
        packer = pack_b if w.dim() == 2 else pack_b_grouped
        return normalize_packed(packer(w, plan.b_format), plan.b_format)

    def _clamp_bm(self, rows: int) -> int:
        # The packed buffer does not depend on bm: clamp the m-block to the
        # runtime row count, so a 4-row decode step is not padded to 64.
        return min(self.plan.bm, -(-max(rows, 1) // ROW_ALIGN) * ROW_ALIGN)


@dataclasses.dataclass
class PackedWeight(_PackedCommon):
    """A [K, N] weight stored tile-major per its plan's :class:`TileFormat`;
    ``scales`` is the dequant grid of a quantized format ([Nb, Kb], or [Nb]
    for ":col"), else None."""

    packed: torch.Tensor
    k: int
    n: int
    plan: GemmPlan
    scales: Optional[torch.Tensor] = None

    @classmethod
    def pack(cls, w: torch.Tensor, *, m_hint: int = 1024,
             plan: Optional[GemmPlan] = None,
             quantize: Optional[str] = None) -> "PackedWeight":
        """Pack ``w`` [K, N] on ``w``'s device."""
        assert w.dim() == 2, tuple(w.shape)
        k, n = w.shape
        b_dtype, gran = _parse_quantize(quantize)
        plan = plan or plan_gemm(m_hint, k, n, dtype_name(w.dtype),
                                 b_dtype=b_dtype, scale_granularity=gran)
        packed, scales = cls._pack_tiles(w, plan, quantize)
        return cls(packed=packed, k=k, n=n, plan=plan, scales=scales)

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
        faults.maybe_fail("kernel_compile")
        out = gemm_packed_fused_a(
            a, self.packed, self.n, bm=self._clamp_bm(a.shape[0]),
            layout_b=self.plan.layout_b,
            b_scales=faults.corrupt("scale_grid", self.scales), bias=bias,
            epilogue=epilogue, b_format=self.fmt,
            out_dtype=out_dtype or a.dtype)
        faults.maybe_fail("kernel_run")
        return out


@dataclasses.dataclass
class GroupedPackedWeight(_PackedCommon):
    """A stacked expert weight [E, K, N] stored tile-major: every expert's
    matrix packed with the same plan into one [E, Nb, Kb, t0, t1] buffer,
    once at load, and consumed by the grouped kernels with the expert as a
    grid axis. ``scales`` is [E, Nb, Kb] (or [E, Nb] for ":col").

    ``n_b_streams=2`` at pack time plans for the fused silu-gate kernel's
    second B stream, so a gate/up pair shares one plan (:meth:`silu_gate`
    checks it).

    On the card every contraction of a packed stack launches the grouped
    kernel: with counts, ``gemm_grouped_packed_ragged``; without,
    ``gemm_grouped_packed``. The reference sends segments of at most one
    sublane block (``C <= 8`` rows in f32) to a masked einsum over the
    whole dequantized stack — a TPU rule that on the card would re-read
    every expert's weights on every decode step and hide the kernel. The
    port keeps the zeroed-tail semantics (rows at or past the count are 0)
    and drops that split: decode-shaped segments run the kernel, whose
    blocks past the count load nothing. On the CPU the same wrappers run
    their plain torch versions.
    """

    packed: torch.Tensor
    e: int
    k: int
    n: int
    plan: GemmPlan
    scales: Optional[torch.Tensor] = None

    @classmethod
    def pack(cls, w: torch.Tensor, *, m_hint: int = 1024,
             plan: Optional[GemmPlan] = None, n_b_streams: int = 1,
             quantize: Optional[str] = None) -> "GroupedPackedWeight":
        """Pack ``w`` [E, K, N] on ``w``'s device."""
        assert w.dim() == 3, tuple(w.shape)
        e, k, n = w.shape
        b_dtype, gran = _parse_quantize(quantize)
        plan = plan or plan_grouped_gemm(
            e, m_hint, k, n, dtype_name(w.dtype), n_b_streams=n_b_streams,
            b_dtype=b_dtype, scale_granularity=gran)
        packed, scales = cls._pack_tiles(w, plan, quantize)
        return cls(packed=packed, e=e, k=k, n=n, plan=plan, scales=scales)

    def _check(self, a: torch.Tensor) -> None:
        if a.dim() != 3 or a.shape[0] != self.e or a.shape[2] != self.k:
            raise ValueError(f"grouped operand mismatch: a={tuple(a.shape)}, "
                             f"weight stack is E={self.e}, K={self.k}")

    def _check_pair(self, up: "GroupedPackedWeight") -> None:
        # Widths first: stacks of different N can pad to the same buffer
        # under one plan, and the kernel would store only the gate's N.
        if (self.e, self.k, self.n) != (up.e, up.k, up.n):
            raise ValueError(
                "silu_gate pair must have one geometry: gate E, K, N = "
                f"{self.e}, {self.k}, {self.n}; up {up.e}, {up.k}, {up.n}")
        if self.plan != up.plan or self.packed.shape != up.packed.shape:
            raise ValueError("silu_gate pair must share plan and geometry "
                             f"({self.plan} vs {up.plan})")
        if (self.scales is None) != (up.scales is None):
            raise ValueError("silu_gate pair must be quantized together")

    def _check_ragged(self, a: torch.Tensor, counts: torch.Tensor) -> None:
        if a.dim() != 4 or a.shape[0] != self.e or a.shape[3] != self.k:
            raise ValueError(f"ragged grouped operand mismatch: "
                             f"a={tuple(a.shape)} must be [E={self.e}, S, C, "
                             f"K={self.k}]")
        if tuple(counts.shape) != tuple(a.shape[:2]):
            raise ValueError(f"counts {tuple(counts.shape)} must match a's "
                             f"[E, S]={tuple(a.shape[:2])}")

    def _kernel_kw(self, b2, out_dtype, a) -> dict:
        """The grouped kernels' keywords; the gate's scale grid passes the
        ``scale_grid`` site (the partner's does not, as in the reference)."""
        return dict(b2_packed=None if b2 is None else b2.packed,
                    layout_b=self.plan.layout_b,
                    b_scales=faults.corrupt("scale_grid", self.scales),
                    b2_scales=None if b2 is None else b2.scales,
                    b_format=self.fmt, out_dtype=out_dtype or a.dtype)

    def _ragged(self, a, counts, *, b2=None, bias=None, epilogue="none",
                out_dtype=None) -> torch.Tensor:
        """The ragged contraction: a [E, S, C, K], counts [E, S] ->
        [E, S, C, N]. ``b2`` is the silu-gate partner weight."""
        if (epilogue == "silu_gate") != (b2 is not None):
            raise ValueError("epilogue='silu_gate' requires the partner "
                             "stack (use silu_gate(), not matmul())")
        faults.maybe_fail("kernel_compile")
        out = gemm_grouped_packed_ragged(
            a, self.packed, self.n, counts, bm=self._clamp_bm(a.shape[2]),
            bias=bias, epilogue=epilogue, **self._kernel_kw(b2, out_dtype, a))
        faults.maybe_fail("kernel_run")
        return out

    def _spec(self, a3, *, epilogue, bias, counts, out_dtype):
        return ContractionSpec.grouped(
            self.e, a3.shape[1], self.k, self.n, a3.dtype, w=self,
            epilogue=epilogue, bias=bias is not None, counts=counts,
            out_dtype=out_dtype)

    def matmul(self, a: torch.Tensor, *, counts=None, bias=None,
               epilogue="none", out_dtype=None) -> torch.Tensor:
        """out[e] = epilogue(a[e] @ W[e] + bias[e]); a [E, M, K], bias
        [E, N]. With ``counts`` [E, S] the call is ragged: ``a`` is
        [E, S, C, K] and rows at or past ``counts[e, s]`` are zero in the
        [E, S, C, N] output."""
        epi = as_epilogue_spec(epilogue)
        if epi.gate_mul:
            raise ValueError("epilogue='silu_gate' requires the partner "
                             "stack (use silu_gate(), not matmul())")
        if counts is not None:
            self._check_ragged(a, counts)
        else:
            self._check(a)
        a3 = a.reshape(self.e, -1, self.k)
        spec = self._spec(a3, epilogue=epi, bias=bias,
                          counts=counts is not None, out_dtype=out_dtype)
        out = self._guarded(spec, a3, lambda lw: lw.run(
            spec, a3, self, bias=bias, counts=counts))
        return out.reshape(*a.shape[:-1], self.n)

    def silu_gate(self, up: "GroupedPackedWeight", a: torch.Tensor, *,
                  counts=None, out_dtype=None) -> torch.Tensor:
        """silu(a @ self) * (a @ up) — the fused MoE gate/up pair, both
        stacks against one read of ``a``; ``counts`` as in :meth:`matmul`."""
        self._check_pair(up)
        for w in (self, up):
            if counts is not None:
                w._check_ragged(a, counts)
            else:
                w._check(a)
        a3 = a.reshape(self.e, -1, self.k)
        spec = self._spec(a3, epilogue=as_epilogue_spec("silu_gate"),
                          bias=None, counts=counts is not None,
                          out_dtype=out_dtype)
        out = self._guarded(spec, a3, lambda lw: lw.run(
            spec, a3, self, w2=up, counts=counts))
        return out.reshape(*a.shape[:-1], self.n)

    @staticmethod
    def _guarded(spec, a3, run_one) -> torch.Tensor:
        """The dispatched lowering, guarded for the device ``a3`` lies on
        (degraded down its fallback chain on the CPU)."""
        on_card = a3.is_cuda
        return ctr.run_guarded(spec, ctr.dispatch(spec, on_card=on_card),
                               run_one, on_card=on_card)

    def _matmul_impl(self, a, *, bias, epilogue: str,
                     out_dtype) -> torch.Tensor:
        """Count-free body: every row of a [E, M, K] is live."""
        faults.maybe_fail("kernel_compile")
        out = gemm_grouped_packed(
            a, self.packed, self.n, bm=self._clamp_bm(a.shape[1]), bias=bias,
            epilogue=epilogue, **self._kernel_kw(None, out_dtype, a))
        faults.maybe_fail("kernel_run")
        return out

    def _silu_gate_impl(self, up: "GroupedPackedWeight", a, *,
                        out_dtype) -> torch.Tensor:
        faults.maybe_fail("kernel_compile")
        out = gemm_grouped_packed(
            a, self.packed, self.n, bm=self._clamp_bm(a.shape[1]),
            epilogue="silu_gate", **self._kernel_kw(up, out_dtype, a))
        faults.maybe_fail("kernel_run")
        return out


def _run_packed_weight(spec, a, w, *, bias=None, c=None, alpha=1.0, beta=0.0,
                       plan=None):
    if c is not None or alpha != 1.0 or beta != 0.0:
        raise ValueError("the packed_weight lowering takes epilogue(a @ W + "
                         "bias) only (no c/alpha/beta)")
    return w._matmul_impl(a, bias=bias, epilogue=spec.epilogue.kernel_name,
                          out_dtype=spec.resolved_out_dtype(a))


ctr.register_lowering(
    "packed_weight", "dense",
    supports=lambda spec: spec.weight == "packed",
    # load-time packing already paid: always the pick
    cost=lambda spec, on_card: 0.0,
    run=_run_packed_weight)


def _run_grouped_packed_weight(spec, a, w, *, w2=None, bias=None,
                               counts=None):
    """Folded operands: a [E, M, K], counts [E, S] (M = S * C)."""
    w._check(a)
    if w2 is not None:
        w._check_pair(w2)
    out_dtype = spec.resolved_out_dtype(a)
    epi = spec.epilogue.kernel_name
    if counts is not None:
        a4 = a.reshape(w.e, counts.shape[1], -1, a.shape[-1])
        out = w._ragged(a4, counts, b2=w2, bias=bias, epilogue=epi,
                        out_dtype=out_dtype)
        return out.reshape(w.e, a.shape[1], w.n)
    if w2 is not None:
        return w._silu_gate_impl(w2, a, out_dtype=out_dtype)
    return w._matmul_impl(a, bias=bias, epilogue=epi, out_dtype=out_dtype)


ctr.register_lowering(
    "grouped_packed_weight", "grouped",
    supports=lambda spec: spec.weight == "packed",
    cost=lambda spec, on_card: 0.0,
    run=_run_grouped_packed_weight)
