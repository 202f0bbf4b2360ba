"""Public contraction API of the port: :func:`contract` executes a declared
:class:`ContractionSpec` (validate -> dispatch -> fold -> run -> restore);
:func:`matmul` (the paper's ``C <- epilogue(alpha * A @ B + beta * C +
bias)``), :func:`linear` and the grouped pair :func:`grouped_linear` /
:func:`grouped_silu_gate` are the facades that build the specs. Unlike
the reference's, they take no ``backend=``: the operands' device decides.

The dense lowerings are ``packed_weight`` (load-time-packed weights, the
fused-A kernel K1) and, for raw weights, the strategies of
``core/strategy.py``: on the card the planner picks ``tiling`` (K7 on the
strided operands) or ``tiling_packing_fused`` (K5 packs B per call, then
K1), and the comparison strategies run when named; on the CPU the auto pick
is ``torch_matmul``. The grouped ones are ``grouped_packed_weight`` (a
:class:`GroupedPackedWeight`, K2 / K3) and, for raw [E, K, N] stacks,
``grouped_einsum``, ``grouped_packed`` and ``grouped_packed_ragged``.
Whether the call targets the card is read from the activation's device.

Env and auto dispatch are guarded (``contraction.run_guarded``): on the CPU
a failing lowering is classified and recorded in ``core.health``'s
registry, and the call degrades down the fallback chain to the plain torch
reference lowering; on the card the winner's failure raises. An explicit
``strategy=`` never degrades: its failures raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import autograd as _autograd
from repro_torch.core import contraction as ctr
from repro_torch.core import strategy as _strategy  # noqa: F401  (registers)
from repro_torch.core.contraction import ContractionSpec, dispatch
from repro_torch.core.epilogue import as_epilogue_spec
from repro_torch.core.planner import GemmPlan
from repro_torch.parallel.mesh import (contiguous_grad, gather_inner_dims,
                                       keep_shards)
from repro_torch.parallel.mesh import is_dtensor as _is_dtensor

# Importing the packed-weight module registers its lowering.
from repro_torch.core import layered as _layered  # noqa: F401  isort: skip

# The lowering a contraction over DTensor operands takes, by kind: the
# plain torch ones, the counterparts of the reference's jnp lowerings that
# GSPMD partitions (``repro/core/contraction.py:65-70``).
DISTRIBUTED_LOWERINGS = {"dense": "torch_matmul", "grouped": "grouped_einsum"}


def is_dtensor(*xs) -> bool:
    """Whether any of ``xs`` is a DTensor (``torch.distributed.tensor``)."""
    return any(_is_dtensor(x) for x in xs)


def fold_grouped(x: torch.Tensor, counts: Optional[torch.Tensor] = None):
    """Fold ``[*lead, E, M, K]`` (+ ``[*lead, E]`` counts) to the
    expert-major form the kernel lowerings take: ``(x3 [E, lead*M, K],
    counts [E, S=prod(lead)] int32 or None, restore)``. Each expert's rows
    are then S contiguous M-row segments, one per leading index — the
    ragged contract's capacity segments, which is why the counts fold the
    same way."""
    lead = x.shape[:-3]
    e, m, k = x.shape[-3:]
    x3 = x.movedim(-3, 0).reshape(e, -1, k)
    fc = None
    if counts is not None:
        if tuple(counts.shape) != tuple(lead) + (e,):
            raise ValueError(f"counts shape {tuple(counts.shape)} != lead "
                             f"{tuple(lead)} + (E={e},)")
        fc = counts.movedim(-1, 0).reshape(e, -1).to(torch.int32).contiguous()

    def restore(y):
        return y.reshape((e,) + tuple(lead) + (m, y.shape[-1])).movedim(0, -3)

    return x3, fc, restore


def _check_gemm_extras(spec, c, alpha, beta) -> None:
    # The c/alpha/beta form is dense-only and raw-weight-only: the grouped
    # lowerings have no accumulate-into-C path, and the packed-weight one
    # takes the linear layer's epilogue only. Checked before the fallback
    # chain, which would otherwise degrade past the refusal.
    if c is None and alpha == 1.0 and beta == 0.0:
        return
    if spec.kind == "grouped":
        raise ValueError("c/alpha/beta are dense-only GEMM operands; got "
                         f"them with {spec.describe()}")
    if spec.weight == "packed":
        raise ValueError("the packed_weight lowering takes epilogue(a @ W + "
                         "bias) only (no c/alpha/beta)")


def _check_operands(spec, w, w2, bias, counts) -> None:
    if ctr.weight_kind(w) != spec.weight:
        raise ValueError(f"weight kind {ctr.weight_kind(w)!r} != spec "
                         f"{spec.weight!r} ({spec.describe()})")
    for name, declared, got in (("bias", spec.epilogue.bias, bias),
                                ("gate_mul partner w2",
                                 spec.epilogue.gate_mul, w2),
                                ("counts", spec.counts, counts)):
        if declared != (got is not None):
            raise ValueError(f"spec declares {name}={declared} but the "
                             f"operand is "
                             f"{'set' if got is not None else 'missing'}")


def contract(spec: ContractionSpec, a: torch.Tensor, w, *, w2=None,
             c: Optional[torch.Tensor] = None, bias=None, counts=None,
             alpha: float = 1.0, beta: float = 0.0,
             strategy: Optional[str] = None,
             plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Execute a declared contraction. Dense: ``a`` is [*lead, K] (``c``
    [*lead, N] when given); leading dims fold into M for the lowering and
    are restored on the way out. Grouped: ``a`` is [*lead, E, M, K] with
    ``counts`` [*lead, E] for a ragged spec and ``w2`` the gate-mul
    partner; folding lowerings see the expert-major form
    (:func:`fold_grouped`). The auto pick targets the card when ``a`` lies
    on it.

    Env / auto dispatch is guarded (``contraction.run_guarded``): on the
    CPU a failing lowering is recorded in the health registry and the call
    degrades down its fallback chain, on the card the winner's failure
    raises; an explicit ``strategy=`` raises, and under the numerics guard
    a non-finite output of it raises too. A call that needs a gradient runs
    each kernel lowering it tries through
    ``core.autograd.KernelContraction`` (dense, raw weight); a packed or
    grouped kernel pick raises before the chain, and the chain skips
    lowerings that carry no gradient. The plain torch lowerings
    differentiate as they are."""
    _check_operands(spec, w, w2, bias, counts)
    _check_gemm_extras(spec, c, alpha, beta)
    on_card = a.is_cuda
    distributed = strategy in (None, "auto") and is_dtensor(a, w, w2, bias)
    if distributed:
        # Operands sharded over a mesh (``parallel.sharding.place``) take
        # the kind's plain torch lowering, which DTensor partitions; it
        # never degrades: an op with no sharding rule raises.
        strategy = DISTRIBUTED_LOWERINGS[spec.kind]
        if spec.kind == "dense":
            a = gather_inner_dims(a, a.ndim - 1)
        else:   # [*lead, E, M, K]: only the leading and expert dims stay split
            a = keep_shards(a, (0, a.ndim - 3))
    low = dispatch(spec, strategy=strategy, on_card=on_card)
    grad = _autograd.needs_grad(a, w, w2, c, bias)
    if grad:
        _autograd.check_differentiable(spec, low)

    def run_one(lw):
        # Folding is per lowering (``folds`` differs down a chain), so the
        # whole body is the guarded runner's unit of retry.
        if spec.kind == "dense":
            a2 = a.reshape(-1, a.shape[-1])
            c2 = None if c is None else c.reshape(-1, c.shape[-1])
            if grad and _autograd.wraps(spec, lw):
                out = _autograd.KernelContraction.apply(
                    a2, w, bias, c2, lw, spec, alpha, beta, plan, strategy)
            else:
                out = lw.run(spec, a2, w, bias=bias, c=c2, alpha=alpha,
                             beta=beta, plan=plan)
            return out.reshape(*a.shape[:-1], out.shape[-1])
        if not lw.folds:
            return lw.run(spec, a, w, w2=w2, bias=bias, counts=counts)
        x3, fc, restore = fold_grouped(a, counts)
        return restore(lw.run(spec, x3, w, w2=w2, bias=bias, counts=fc))

    if strategy is not None and strategy != "auto":
        out = run_one(low)
        ctr.check_explicit_numerics(spec, low, out)
        return contiguous_grad(out) if distributed else out
    usable = (lambda lw: _autograd.differentiable(spec, lw)) if grad else None
    return ctr.run_guarded(spec, low, run_one, on_card=on_card, usable=usable)


def matmul(a: torch.Tensor, b, c: Optional[torch.Tensor] = None, *,
           alpha: float = 1.0, beta: float = 0.0, strategy: str = "auto",
           plan: Optional[GemmPlan] = None, out_dtype=None,
           bias: Optional[torch.Tensor] = None,
           epilogue="none") -> torch.Tensor:
    """``C <- epilogue(alpha * A @ B + beta * C + bias)``, 2-D operands.

    ``b`` is a raw [K, N] tensor or a :class:`PackedWeight`. ``accum`` is
    pinned to "f32": the GEMM contract accumulates and applies the epilogue
    in full precision. ``strategy`` names a lowering (any of
    ``core.strategy.STRATEGIES`` for a raw ``b``) or "auto"."""
    m, k = a.shape
    n = b.n if ctr.is_packed(b) else b.shape[1]
    spec = ContractionSpec.dense(
        m, k, n, a.dtype, w=b, epilogue=as_epilogue_spec(epilogue),
        bias=bias is not None, out_dtype=out_dtype, accum="f32")
    return contract(spec, a, b, c=c, bias=bias, alpha=alpha, beta=beta,
                    strategy=strategy, plan=plan)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
           strategy: str = "auto", plan: Optional[GemmPlan] = None,
           out_dtype=None, accum: str = "native",
           epilogue="none") -> torch.Tensor:
    """y = epilogue(x @ w + bias) with any leading batch dims on x; ``w`` is
    a raw [K, N] tensor or a :class:`PackedWeight`; ``plan`` overrides the
    planner's blocks for a raw weight's kernel strategy."""
    k = x.shape[-1]
    n = w.n if ctr.is_packed(w) else w.shape[-1]
    m = x.numel() // max(k, 1)
    spec = ContractionSpec.dense(
        m, k, n, x.dtype, w=w, epilogue=as_epilogue_spec(epilogue),
        bias=bias is not None, out_dtype=out_dtype or x.dtype, accum=accum)
    return contract(spec, x, w, bias=bias, strategy=strategy, plan=plan)


def grouped_linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, *,
                   counts: Optional[torch.Tensor] = None,
                   occupancy: Optional[float] = None, strategy: str = "auto",
                   out_dtype=None, epilogue="none") -> torch.Tensor:
    """``out[..., e, m, :] = epilogue(x[..., e, m, :] @ w[e] + bias[e])``.

    The grouped :func:`linear`: ``x`` is [*lead, E, M, K] (the leading dims
    fold into M), ``w`` a raw [E, K, N] stack or a
    :class:`GroupedPackedWeight`, ``bias`` [E, N]. ``counts`` ([*lead, E],
    at most M) makes the contraction ragged: rows at or past the count are
    padding, zero in the output, and a packed stack launches K2 (without
    counts, K3). ``occupancy`` in (0, 1] is the expected fill, the auto
    pick's prior."""
    e, m, k = x.shape[-3:]
    n = w.n if ctr.is_packed(w) else w.shape[-1]
    lead = x.numel() // max(e * m * k, 1)
    spec = ContractionSpec.grouped(
        e, lead * m, k, n, x.dtype, w=w, epilogue=as_epilogue_spec(epilogue),
        bias=bias is not None, counts=counts is not None,
        occupancy=occupancy, out_dtype=out_dtype or x.dtype)
    return contract(spec, x, w, bias=bias, counts=counts, strategy=strategy)


def grouped_silu_gate(x: torch.Tensor, wg, wu, *,
                      counts: Optional[torch.Tensor] = None,
                      occupancy: Optional[float] = None, strategy: str = "auto",
                      out_dtype=None) -> torch.Tensor:
    """``silu(x @ wg) * (x @ wu)`` per expert, the MoE gate/up pair: one
    ``silu_gate`` contraction with ``wu`` as the gate-mul partner, so the
    kernel lowerings read A once for both stacks. ``counts`` and
    ``occupancy`` as in :func:`grouped_linear`; with counts both products
    skip the padding rows."""
    if ctr.is_packed(wg) != ctr.is_packed(wu):
        raise ValueError("gate/up pair must be both packed or both raw")
    e, m, k = x.shape[-3:]
    n = wg.n if ctr.is_packed(wg) else wg.shape[-1]
    lead = x.numel() // max(e * m * k, 1)
    spec = ContractionSpec.grouped(
        e, lead * m, k, n, x.dtype, w=wg,
        epilogue=as_epilogue_spec("silu_gate"), counts=counts is not None,
        occupancy=occupancy, out_dtype=out_dtype or x.dtype)
    return contract(spec, x, wg, w2=wu, counts=counts, strategy=strategy)


def resolve_strategy(m: int, k: int, n: int, dtype, strategy: str = "auto",
                     *, on_card: bool = False) -> str:
    """The lowering ``dispatch`` chooses for a raw-weight dense contraction
    (explicit > env > auto), by name."""
    spec = ContractionSpec.dense(m, k, n, dtype)
    return dispatch(spec, strategy=strategy, on_card=on_card).name


def resolve_grouped_strategy(e: int, m: int, k: int, n: int, dtype,
                             strategy: str = "auto", *,
                             counts_known: bool = False,
                             occupancy: float = 1.0,
                             on_card: bool = False) -> str:
    """The lowering ``dispatch`` chooses for a raw-stack grouped
    contraction, by name. An env override naming a dense lowering never
    re-routes it."""
    spec = ContractionSpec.grouped(e, m, k, n, dtype, counts=counts_known,
                                   occupancy=occupancy)
    return dispatch(spec, strategy=strategy, on_card=on_card).name


run_strategy = _strategy.run
run_grouped_strategy = _strategy.run_grouped

__all__ = ["contract", "dispatch", "fold_grouped", "linear", "matmul",
           "grouped_linear", "grouped_silu_gate", "resolve_strategy",
           "resolve_grouped_strategy", "run_strategy", "run_grouped_strategy",
           "ContractionSpec"]
