"""Code-generation strategies — the paper's §4.1.3 comparison, as lowerings
of the same GEMM ``C <- epilogue(alpha * A @ B + beta * C + bias)``:

  naive           rank-1 updates over K, no blocking (plain torch, as the
                  reference's is plain jnp: it is not a kernel)
  pluto           conservative 32-wide tiles, broadcast-multiply-add micro
                  kernel, no packing (plain torch)
  intrinsic       the whole GEMM as ONE block of ``gemm_tiled`` (K7)
  tiling          planner-blocked ``gemm_tiled`` (K7) on strided operands
  tiling_packing  ``pack_a`` + ``pack_b`` (K5), then ``gemm_packed`` (K6)
  tiling_packing_fused
                  ``pack_b`` (K5, quantizing first for a quantized plan),
                  then ``gemm_packed_fused_a`` (K1) streaming A pack-free
  vsx             ``matmul_vsx_like`` (K8): rank-1 CUDA-core updates, no
                  tensor cores, then the epilogue in torch
  torch_matmul    the library proxy (the reference's ``xla``): one
                  ``torch.matmul``, never the auto pick on the card

and the grouped (MoE expert) lowerings of ``out[e] = A[e] @ B[e]`` over raw
[E, K, N] stacks:

  grouped_einsum  one batched einsum (the library lowering)
  grouped_packed  ``pack_b_grouped`` (K5), then ``gemm_grouped_packed`` (K3)
  grouped_packed_ragged
                  ``pack_b_grouped`` (K5), then
                  ``gemm_grouped_packed_ragged`` (K2), skipping the rows at
                  or past the per-segment counts

and the reference lowerings ``torch_ref`` (dense) and ``grouped_torch_ref``
(grouped), the bottom of every guarded fallback chain: plain torch in f32,
packed weights unpacked (and dequantized) through the plain inverses of
``kernels.ref``, supporting every spec of their kind at
``contraction.REFERENCE_COST``, with no fault site inside.

Each kernel wrapper runs its CUDA kernel on CUDA tensors and its plain torch
version on CPU tensors, so one table serves both devices (the reference's
``backend="pallas"``). On the card, auto dispatch takes the planner's pick
(``choose_strategy``: ``tiling`` or ``tiling_packing_fused``;
``choose_grouped_strategy`` for stacks); on the CPU ``torch_matmul`` and
``grouped_einsum``, as the reference takes ``xla`` and ``grouped_einsum``
off the TPU. Every strategy here registers with the one dispatch point.

The fault sites of the reference (``repro_torch.testing.faults``) sit where
its lowerings have them: ``kernel_compile`` before and ``kernel_run`` after
each registered lowering's body, ``pack`` and ``scale_grid`` where a
per-call strategy packs B.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import contraction as ctr
from repro_torch.core.dtypes import dtype_name
from repro_torch.core.epilogue import as_epilogue_spec
from repro_torch.core.planner import (GemmPlan, choose_grouped_strategy,
                                      choose_strategy, plan_gemm,
                                      plan_grouped_gemm)
from repro_torch.core.tile_format import TileFormat, normalize_packed
from repro_torch.kernels.common import KERNEL_EPILOGUES, pad2d
from repro_torch.kernels.gemm_grouped import (gemm_grouped_packed,
                                              gemm_grouped_packed_ragged)
from repro_torch.kernels.gemm_packed import gemm_packed, gemm_packed_fused_a
from repro_torch.kernels.gemm_tiled import gemm_tiled
from repro_torch.kernels.gemm_vsx_like import matmul_vsx_like
from repro_torch.kernels import ref
from repro_torch.kernels.pack import pack_a, pack_b, pack_b_grouped
from repro_torch.kernels.ref import grouped_ragged_ref, ragged_row_mask
from repro_torch.testing import faults

STRATEGIES = ("naive", "pluto", "intrinsic", "tiling", "tiling_packing",
              "tiling_packing_fused", "vsx", "torch_matmul")
GROUPED_STRATEGIES = ("grouped_einsum", "grouped_packed",
                      "grouped_packed_ragged")

# The dense lowerings auto dispatch may pick; the rest are the paper's
# comparison lowerings, runnable when named.
_DENSE_CONTENDERS = ("tiling", "tiling_packing_fused", "torch_matmul")


def _epilogue(acc, c, alpha, beta, out_dtype, bias=None, epilogue="none"):
    """alpha, beta * C, then the EpilogueSpec chain (bias, activation) on
    the accumulator, then one cast: the trailing torch ops of the
    strategies whose kernel (or loop) has no store epilogue."""
    out = alpha * acc
    if c is not None and beta != 0:
        out = out + beta * c.to(acc.dtype)
    spec = as_epilogue_spec(epilogue).with_bias(bias is not None)
    return spec.apply(out, bias=bias).to(out_dtype)


@functools.lru_cache(maxsize=4096)
def _default_plan(m: int, k: int, n: int, dtype: str) -> GemmPlan:
    """The planner's blocks for a shape, solved once per shape."""
    return plan_gemm(m, k, n, dtype)


def _plan(plan: Optional[GemmPlan], a, b) -> GemmPlan:
    return plan or _default_plan(a.shape[0], a.shape[1], b.shape[1],
                                 dtype_name(a.dtype))


# ---------------------------------------------------------------------------
# Dense lowerings
# ---------------------------------------------------------------------------

def _naive(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
           epilogue="none"):
    """Rank-1 update loop over K, unblocked, in f32."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for kk in range(a.shape[1]):
        acc += a32[:, kk:kk + 1] * b32[kk:kk + 1, :]
    return _epilogue(acc, c, alpha, beta, out_dtype, bias, epilogue)


def _pluto(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
           epilogue="none"):
    """PLuTo's conservative tiling: fixed 32-wide tiles whatever the target,
    operands read from their own layout (a strided blocked view, no packing
    copy), a broadcast-multiply-add micro kernel (no matrix intrinsic). The
    K-tiles are a loop; every output tile takes the same micro-kernel step
    at once."""
    t = 32
    m, n = a.shape[0], b.shape[1]
    ap = pad2d(a, t, t).to(torch.float32)
    bp = pad2d(b, t, t).to(torch.float32)
    mb, kb, nb = ap.shape[0] // t, ap.shape[1] // t, bp.shape[1] // t
    a4 = ap.reshape(mb, t, kb, t).permute(0, 2, 1, 3)        # [i, k, r, q]
    b4 = bp.reshape(kb, t, nb, t).permute(0, 2, 1, 3)        # [k, j, q, c]
    acc = torch.zeros((mb, nb, t, t), dtype=torch.float32, device=a.device)
    for kk in range(kb):
        prod = a4[:, kk][:, None, :, :, None] * b4[kk][None, :, None, :, :]
        acc += prod.sum(dim=3)
    out = acc.permute(0, 2, 1, 3).reshape(mb * t, nb * t)[:m, :n]
    return _epilogue(out, c, alpha, beta, out_dtype, bias, epilogue)


def _intrinsic(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
               epilogue="none"):
    """The whole problem as one block of the tiled kernel (the reference's
    one-step grid)."""
    return gemm_tiled(a, b, c, alpha=alpha, beta=beta, out_dtype=out_dtype,
                      epilogue=epilogue, bias=bias, single_block=True)


def _tiling(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
            epilogue="none"):
    return gemm_tiled(a, b, c, alpha=alpha, beta=beta, out_dtype=out_dtype,
                      epilogue=epilogue, bias=bias, bm=_plan(plan, a, b).bm)


def _tiling_packing(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
                    epilogue="none"):
    """Both operands packed tile-major per call, then the packed kernel."""
    plan = _plan(plan, a, b)
    ap = pack_a(a, plan.bm, plan.bk, layout=plan.layout_a)
    bp = pack_b(b, plan.bk, plan.bn, layout=plan.layout_b)
    return gemm_packed(ap, bp, a.shape[0], b.shape[1], c, alpha=alpha,
                       beta=beta, layout_a=plan.layout_a,
                       layout_b=plan.layout_b, out_dtype=out_dtype,
                       epilogue=epilogue, bias=bias)


def _plan_pack_format(plan: GemmPlan, b) -> TileFormat:
    """The format a per-call strategy packs B to: the plan's, with an
    unquantized format retargeted to B's own dtype (only quantized formats
    convert)."""
    fmt = plan.b_format
    if not fmt.is_quantized:
        fmt = dataclasses.replace(fmt, dtype=dtype_name(b.dtype))
    return fmt


def _pack_b_plan(plan: GemmPlan, b):
    """B [K, N] (or a stack [E, K, N]) packed per the plan's format:
    ``(format, packed, scales-or-None)``; a quantized plan quantizes here,
    per call."""
    faults.maybe_fail("pack")
    fmt = _plan_pack_format(plan, b)
    packer = pack_b if b.dim() == 2 else pack_b_grouped
    packed, scales = normalize_packed(packer(b, fmt), fmt)
    return fmt, packed, faults.corrupt("scale_grid", scales)


def _tiling_packing_fused(a, b, c, alpha, beta, plan, out_dtype, *,
                          bias=None, epilogue="none"):
    """B packed per call, A streamed pack-free from its natural layout."""
    plan = _plan(plan, a, b)
    fmt, bp, scales = _pack_b_plan(plan, b)
    return gemm_packed_fused_a(a, bp, b.shape[1], c, bm=plan.bm, alpha=alpha,
                               beta=beta, layout_b=fmt.layout,
                               b_scales=scales, out_dtype=out_dtype,
                               epilogue=epilogue, bias=bias, b_format=fmt)


def _vsx(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
         epilogue="none"):
    """The generic vector-unit product in f32, the epilogue in torch."""
    acc = matmul_vsx_like(a, b, out_dtype=torch.float32,
                          bm=_plan(plan, a, b).bm)
    return _epilogue(acc, c, alpha, beta, out_dtype, bias, epilogue)


def _torch_matmul(a, b, c, alpha, beta, plan, out_dtype, *, bias=None,
                  epilogue="none"):
    """The library proxy: the product accumulated in f32, then the
    epilogue."""
    acc = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return _epilogue(acc, c, alpha, beta, out_dtype, bias, epilogue)


_DENSE: Dict[str, Callable] = {
    "naive": _naive,
    "pluto": _pluto,
    "intrinsic": _intrinsic,
    "tiling": _tiling,
    "tiling_packing": _tiling_packing,
    "tiling_packing_fused": _tiling_packing_fused,
    "vsx": _vsx,
    "torch_matmul": _torch_matmul,
}


def run(strategy: str, a: torch.Tensor, b: torch.Tensor,
        c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
        beta: float = 0.0, plan: Optional[GemmPlan] = None, out_dtype=None,
        bias: Optional[torch.Tensor] = None,
        epilogue="none") -> torch.Tensor:
    """``C <- epilogue(alpha * A @ B + beta * C + bias)`` by the named
    strategy; A [M, K], B [K, N]. ``out_dtype`` defaults to C's dtype, else
    A's."""
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    out_dtype = out_dtype or (c.dtype if c is not None else a.dtype)
    return _DENSE[strategy](a, b, c, alpha, beta, plan, out_dtype, bias=bias,
                            epilogue=getattr(epilogue, "kernel_name",
                                             epilogue))


# ---------------------------------------------------------------------------
# Grouped lowerings
# ---------------------------------------------------------------------------

def grouped_epilogue(acc, acc2, bias, epilogue, out_dtype):
    """The grouped epilogue chain on [E, M, N] accumulators: bias [E, N],
    then the activation (or silu(acc) * acc2 for the gate pair), then one
    cast."""
    spec = as_epilogue_spec(epilogue).with_bias(bias is not None)
    b = bias[:, None, :] if bias is not None else None
    return spec.apply(acc, bias=b, gate=acc2).to(out_dtype)


def mask_ragged_rows(x: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Zero the rows at or past the counts: x [*lead, E, C, ...], counts
    [*lead, E]. The product is row-local, so masking the output alone
    establishes the ragged contract."""
    mask = ragged_row_mask(x.shape[-2], counts)[..., None]
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def run_grouped(strategy: str, a: torch.Tensor, b: torch.Tensor, *,
                b2: Optional[torch.Tensor] = None,
                counts: Optional[torch.Tensor] = None,
                plan: Optional[GemmPlan] = None, out_dtype=None,
                bias: Optional[torch.Tensor] = None,
                epilogue="none") -> torch.Tensor:
    """out[e] = epilogue(A[e] @ B[e] (+ bias[e])); a [E, M, K], b (and the
    silu-gate partner ``b2``) raw [E, K, N]. ``counts`` [E, S] (M = S * C)
    selects the ragged contract: rows at or past ``counts[e, s]`` are zero
    in the output. ``grouped_packed_ragged`` requires counts,
    ``grouped_packed`` rejects them, ``grouped_einsum`` masks them."""
    epilogue = getattr(epilogue, "kernel_name", epilogue)
    if strategy not in GROUPED_STRATEGIES:
        raise KeyError(f"unknown grouped strategy {strategy!r}; one of "
                       f"{GROUPED_STRATEGIES}")
    if (b2 is not None) != (epilogue == "silu_gate"):
        raise ValueError("b2 goes with epilogue='silu_gate' (and only then)")
    if strategy == "grouped_packed_ragged" and counts is None:
        raise ValueError("grouped_packed_ragged requires counts")
    if strategy == "grouped_packed" and counts is not None:
        raise ValueError("grouped_packed ignores counts — use "
                         "grouped_packed_ragged")
    e, m, k = a.shape
    n = b.shape[2]
    out_dtype = out_dtype or a.dtype
    if counts is not None and (counts.shape[0] != e or m % counts.shape[1]):
        raise ValueError(f"counts [E, S]={tuple(counts.shape)} incompatible "
                         f"with a={tuple(a.shape)}")
    if strategy == "grouped_einsum":
        if counts is not None:
            s = counts.shape[1]
            act = (None if epilogue in ("none", "silu_gate")
                   else KERNEL_EPILOGUES[epilogue])
            return grouped_ragged_ref(
                a.reshape(e, s, m // s, k), b, counts, b2=b2, bias=bias,
                epilogue_fn=act, out_dtype=out_dtype).reshape(e, m, n)
        acc = torch.einsum("emk,ekn->emn", a, b)
        acc2 = torch.einsum("emk,ekn->emn", a, b2) if b2 is not None else None
        return grouped_epilogue(acc, acc2, bias, epilogue, out_dtype)
    plan = plan or plan_grouped_gemm(e, m, k, n, dtype_name(a.dtype),
                                     n_b_streams=2 if b2 is not None else 1)
    fmt, bp, bs = _pack_b_plan(plan, b)
    b2p, b2s = (None, None) if b2 is None else _pack_b_plan(plan, b2)[1:]
    kw = dict(b2_packed=b2p, layout_b=fmt.layout, b_scales=bs, b2_scales=b2s,
              out_dtype=out_dtype, epilogue=epilogue, bias=bias, b_format=fmt)
    if strategy == "grouped_packed_ragged":
        s = counts.shape[1]
        return gemm_grouped_packed_ragged(
            a.reshape(e, s, m // s, k), bp, n, counts,
            bm=min(plan.bm, -(-max(m // s, 1) // 16) * 16),
            **kw).reshape(e, m, n)
    return gemm_grouped_packed(a, bp, n, bm=min(plan.bm, -(-m // 16) * 16),
                               **kw)


# ---------------------------------------------------------------------------
# Registrations: every lowering declares what it supports and a planner cost
# hint; repro_torch.core.contraction.dispatch does the choosing
# ---------------------------------------------------------------------------

def _dense_supports(spec: ctr.ContractionSpec) -> bool:
    # One envelope for the per-call dense lowerings: a raw [K, N] weight,
    # any activation in the table, bias welcome.
    return spec.weight == "raw"


@functools.lru_cache(maxsize=4096)
def _dense_auto(spec: ctr.ContractionSpec, on_card: bool) -> str:
    """The planner's dense pick: the kernels on the card, the library
    lowering elsewhere. Solved once per spec: every contender's cost reads
    it on every dispatch."""
    if on_card:
        return choose_strategy(spec.m, spec.k, spec.n, spec.dtype,
                               b_dtype=spec.b_dtype)
    return "torch_matmul"


def _dense_cost(name: str):
    def cost(spec: ctr.ContractionSpec, on_card: bool) -> float:
        if name not in _DENSE_CONTENDERS:
            return ctr.COMPARISON_COST
        return 0.0 if _dense_auto(spec, on_card) == name else 1.0
    return cost


def _dense_run(name: str):
    def _run(spec, a, w, *, bias=None, c=None, alpha=1.0, beta=0.0,
             plan=None):
        faults.maybe_fail("kernel_compile")
        out = run(name, a, w, c, alpha=alpha, beta=beta, plan=plan,
                  out_dtype=spec.resolved_out_dtype(a, c), bias=bias,
                  epilogue=spec.epilogue.kernel_name)
        faults.maybe_fail("kernel_run")
        return out
    return _run


def _torch_matmul_facade_run(spec, a, w, *, bias=None, c=None, alpha=1.0,
                             beta=0.0, plan=None):
    """The library lowering as the facades use it: ``accum="f32"``
    contracts and applies the epilogue in f32 (the matmul contract);
    ``"native"`` keeps the product in the input dtype and applies the
    epilogue in the output dtype, with no c/alpha/beta."""
    faults.maybe_fail("kernel_compile")
    out_dtype = spec.resolved_out_dtype(a, c)
    epi = spec.epilogue.with_bias(bias is not None)
    if spec.accum == "f32":
        acc = torch.matmul(a.to(torch.float32), w.to(torch.float32))
        out = _epilogue(acc, c, alpha, beta, out_dtype, bias, epi)
    else:
        if c is not None or alpha != 1.0 or beta != 0.0:
            raise ValueError("c/alpha/beta need accum='f32' (matmul "
                             "semantics)")
        dt = torch.promote_types(a.dtype, w.dtype)
        acc = torch.matmul(a.to(dt), w.to(dt))
        out = epi.apply(acc.to(out_dtype), bias=bias)
    faults.maybe_fail("kernel_run")
    return out


@functools.lru_cache(maxsize=4096)
def _grouped_auto(spec: ctr.ContractionSpec, on_card: bool) -> str:
    if on_card:
        return choose_grouped_strategy(
            spec.e, spec.m, spec.k, spec.n, spec.dtype, b_dtype=spec.b_dtype,
            counts_known=spec.counts, occupancy=spec.occupancy)
    return "grouped_einsum"


def _grouped_cost(name: str):
    def cost(spec: ctr.ContractionSpec, on_card: bool) -> float:
        return 0.0 if _grouped_auto(spec, on_card) == name else 1.0
    return cost


def _grouped_einsum_run(spec, a, w, *, w2=None, bias=None, counts=None):
    """Raw expert stacks on UNFOLDED operands (a [*lead, E, M, K], counts
    [*lead, E]): one batched einsum per stream in the activation dtype, the
    epilogue chain, and the ragged contract as an output mask."""
    faults.maybe_fail("kernel_compile")
    acc = torch.einsum("...emk,ekn->...emn", a, w)
    acc2 = (torch.einsum("...emk,ekn->...emn", a, w2)
            if w2 is not None else None)
    epi = spec.epilogue.with_bias(bias is not None)
    out = epi.apply(acc, bias=None if bias is None else bias[:, None, :],
                    gate=acc2).to(spec.resolved_out_dtype(a))
    out = mask_ragged_rows(out, counts) if counts is not None else out
    faults.maybe_fail("kernel_run")
    return out


def _grouped_kernel_run(name: str):
    def _run(spec, a, w, *, w2=None, bias=None, counts=None):
        faults.maybe_fail("kernel_compile")
        out = run_grouped(name, a, w, b2=w2, counts=counts, bias=bias,
                          epilogue=spec.epilogue.kernel_name,
                          out_dtype=spec.resolved_out_dtype(a))
        faults.maybe_fail("kernel_run")
        return out
    return _run


# ---------------------------------------------------------------------------
# Reference lowerings: the bottom of every guarded fallback chain
# ---------------------------------------------------------------------------

def _natural_weight(w) -> torch.Tensor:
    """A weight in its natural [K, N] (or [E, K, N]) form: a packed one
    unpacked, and dequantized where quantized, by the plain inverses."""
    if not ctr.is_packed(w):
        return w
    if w.packed.dim() == 5:
        return ref.unpack_b_grouped_ref(w.packed, w.k, w.n, w.plan.layout_b,
                                        scales=w.scales, fmt=w.fmt)
    return ref.unpack_b_dequant_ref(w.packed, w.scales, w.k, w.n,
                                    w.plan.layout_b, fmt=w.fmt)


def _dense_ref_run(spec, a, w, *, bias=None, c=None, alpha=1.0, beta=0.0,
                   plan=None):
    """The dense reference: one f32 ``torch.matmul`` on the natural weight,
    then the epilogue. It accumulates in f32 whatever ``spec.accum`` says
    (a degraded contraction trades the native accumulation for completing
    at all)."""
    acc = torch.matmul(a.to(torch.float32),
                       _natural_weight(w).to(torch.float32))
    return _epilogue(acc, c, alpha, beta, spec.resolved_out_dtype(a, c),
                     bias, spec.epilogue.kernel_name)


def _grouped_ref_run(spec, a, w, *, w2=None, bias=None, counts=None):
    """The grouped reference on folded operands (a [E, M, K], counts
    [E, S]): a batched f32 einsum on the natural stacks, the ragged
    contract through the masked plain oracle."""
    if spec.epilogue.gate_mul and w2 is None:
        raise ValueError("epilogue='silu_gate' requires the partner stack")
    b = _natural_weight(w)
    b2 = None if w2 is None else _natural_weight(w2)
    e, m, k = a.shape
    out_dtype = spec.resolved_out_dtype(a)
    epi = spec.epilogue.kernel_name
    if counts is not None:
        s = counts.shape[1]
        act = (None if epi in ("none", "silu_gate")
               else KERNEL_EPILOGUES[epi])
        return grouped_ragged_ref(
            a.reshape(e, s, m // s, k), b, counts, b2=b2, bias=bias,
            epilogue_fn=act, out_dtype=out_dtype).reshape(e, m, -1)
    a32 = a.to(torch.float32)
    acc = torch.einsum("emk,ekn->emn", a32, b.to(torch.float32))
    acc2 = (torch.einsum("emk,ekn->emn", a32, b2.to(torch.float32))
            if b2 is not None else None)
    return grouped_epilogue(acc, acc2, bias, epi, out_dtype)


for _name in STRATEGIES:
    if _name != "torch_matmul":
        ctr.register_lowering(_name, "dense", supports=_dense_supports,
                              cost=_dense_cost(_name), run=_dense_run(_name))
ctr.register_lowering("torch_matmul", "dense", supports=_dense_supports,
                      cost=_dense_cost("torch_matmul"),
                      run=_torch_matmul_facade_run)

ctr.register_lowering(
    "grouped_einsum", "grouped",
    supports=lambda spec: spec.weight == "raw",
    cost=_grouped_cost("grouped_einsum"), run=_grouped_einsum_run,
    folds=False)
ctr.register_lowering(
    "grouped_packed", "grouped",
    supports=lambda spec: spec.weight == "raw" and not spec.counts,
    cost=_grouped_cost("grouped_packed"),
    run=_grouped_kernel_run("grouped_packed"),
    # counts strictly add information: an explicit / env choice of the
    # padded kernel on a spec with counts lands on the ragged one
    upgrade=lambda spec: "grouped_packed_ragged" if spec.counts else None)
ctr.register_lowering(
    "grouped_packed_ragged", "grouped",
    supports=lambda spec: spec.weight == "raw" and spec.counts,
    cost=_grouped_cost("grouped_packed_ragged"),
    run=_grouped_kernel_run("grouped_packed_ragged"))

# The reference lowerings support everything of their kind at a huge but
# finite cost: never the auto pick while a real lowering supports the spec,
# always the last entry of a fallback chain.
ctr.register_lowering("torch_ref", "dense", supports=lambda spec: True,
                      cost=lambda spec, on_card: ctr.REFERENCE_COST,
                      run=_dense_ref_run)
ctr.register_lowering("grouped_torch_ref", "grouped",
                      supports=lambda spec: True,
                      cost=lambda spec, on_card: ctr.REFERENCE_COST,
                      run=_grouped_ref_run)
ctr.REFERENCE_LOWERINGS.update({"dense": "torch_ref",
                                "grouped": "grouped_torch_ref"})
