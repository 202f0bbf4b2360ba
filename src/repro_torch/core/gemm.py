"""Public contraction API of the port: :func:`contract` executes a declared
:class:`ContractionSpec` (validate -> dispatch -> fold -> run -> restore);
:func:`matmul` (the paper's ``C <- epilogue(alpha * A @ B + beta * C +
bias)``) and :func:`linear` are the facades that build the specs.

The dense lowerings are ``packed_weight`` (load-time-packed weights, the
fused-A kernel K1) and, for raw weights, the strategies of
``core/strategy.py``: on the card the planner picks ``tiling`` (K7 on the
strided operands) or ``tiling_packing_fused`` (K5 packs B per call, then
K1), and the comparison strategies run when named; on the CPU the auto pick
is ``torch_matmul``. The grouped ones are ``grouped_packed_weight`` (a
:class:`GroupedPackedWeight`, K2 / K3) and, for raw [E, K, N] stacks,
``grouped_einsum``, ``grouped_packed`` and ``grouped_packed_ragged``.
Whether the call targets the card is read from the activation's device.
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

# Importing the packed-weight module registers its lowering.
from repro_torch.core import layered as _layered  # noqa: F401  isort: skip


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
    # The c/alpha/beta form is dense-only: the grouped lowerings have no
    # accumulate-into-C path, so reject rather than compute alpha=1, beta=0.
    if spec.kind == "grouped" and (c is not None or alpha != 1.0
                                   or beta != 0.0):
        raise ValueError("c/alpha/beta are dense-only GEMM operands; got "
                         f"them with {spec.describe()}")


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
    on it. A call that needs a gradient runs a kernel lowering through
    ``core.autograd.KernelContraction`` (dense, raw weight) or raises (a
    packed or grouped kernel lowering); the plain torch lowerings
    differentiate as they are."""
    _check_operands(spec, w, w2, bias, counts)
    _check_gemm_extras(spec, c, alpha, beta)
    low = dispatch(spec, strategy=strategy, on_card=a.is_cuda)
    grad = _autograd.needs_grad(a, w, w2, c, bias)
    if grad:
        _autograd.check_differentiable(spec, low)
    if spec.kind == "dense":
        lead = a.shape[:-1]
        if c is not None:
            c = c.reshape(-1, c.shape[-1])
        a2 = a.reshape(-1, a.shape[-1])
        if grad and _autograd.wraps(spec, low):
            out = _autograd.KernelContraction.apply(
                a2, w, bias, c, low, spec, alpha, beta, plan, strategy)
        else:
            out = low.run(spec, a2, w, bias=bias, c=c, alpha=alpha,
                          beta=beta, plan=plan)
        return out.reshape(*lead, out.shape[-1])
    if not low.folds:
        return low.run(spec, a, w, w2=w2, bias=bias, counts=counts)
    x3, fc, restore = fold_grouped(a, counts)
    return restore(low.run(spec, x3, w, w2=w2, bias=bias, counts=fc))


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
           strategy: str = "auto", out_dtype=None, accum: str = "native",
           epilogue="none") -> torch.Tensor:
    """y = epilogue(x @ w + bias) with any leading batch dims on x; ``w`` is
    a raw [K, N] tensor or a :class:`PackedWeight`."""
    k = x.shape[-1]
    n = w.n if ctr.is_packed(w) else w.shape[-1]
    m = x.numel() // max(k, 1)
    spec = ContractionSpec.dense(
        m, k, n, x.dtype, w=w, epilogue=as_epilogue_spec(epilogue),
        bias=bias is not None, out_dtype=out_dtype or x.dtype, accum=accum)
    return contract(spec, x, w, bias=bias, strategy=strategy)


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
           "resolve_strategy", "resolve_grouped_strategy", "run_strategy",
           "run_grouped_strategy", "ContractionSpec"]
