"""Public contraction API of the port: :func:`contract` executes a declared
:class:`ContractionSpec` (validate -> dispatch -> fold -> run -> restore)
and :func:`linear` is the facade the dense model layers call.

Two dense lowerings are registered: ``packed_weight`` (load-time-packed
weights, the fused-A CUDA kernel on the card) and ``torch_matmul`` (raw
weights, plain torch, CPU only — on the card raw weights would lower to the
blocked kernel ``gemm_tiled``, which is not ported yet). Two grouped ones:
``grouped_packed_weight`` (a :class:`GroupedPackedWeight`, the grouped
CUDA kernel on the card) and ``grouped_einsum`` (raw [E, K, N] stacks, one
batched ``torch.einsum`` on unfolded operands, as the reference leaves its
raw expert contractions to XLA outside any kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import contraction as ctr
from repro_torch.core.contraction import ContractionSpec, dispatch
from repro_torch.core.epilogue import as_epilogue_spec
from repro_torch.kernels.ref import ragged_row_mask

# Importing the packed-weight module registers its lowering.
from repro_torch.core import layered as _layered  # noqa: F401  isort: skip


def _run_torch_matmul(spec, a, w, *, bias=None):
    """Raw [K, N] weight, plain torch (the reference's jnp-backend library
    lowering): ``accum="f32"`` contracts and applies the epilogue in f32;
    ``"native"`` keeps the product in the input dtype."""
    if a.is_cuda:
        raise NotImplementedError(
            "raw-weight contractions on the card lower to the blocked kernel "
            "gemm_tiled (K7), which is not ported yet; serve with "
            "ServeConfig(pack_weights=True)")
    out_dtype = spec.resolved_out_dtype(a)
    epi = spec.epilogue.with_bias(bias is not None)
    if spec.accum == "f32":
        acc = torch.matmul(a.to(torch.float32), w.to(torch.float32))
        return epi.apply(acc, bias=bias).to(out_dtype)
    dt = torch.promote_types(a.dtype, w.dtype)
    acc = torch.matmul(a.to(dt), w.to(dt))
    return epi.apply(acc.to(out_dtype), bias=bias)


ctr.register_lowering(
    "torch_matmul", "dense",
    supports=lambda spec: spec.weight == "raw",
    cost=lambda spec: 0.0,
    run=_run_torch_matmul)


def _run_grouped_einsum(spec, a, w, *, w2=None, bias=None, counts=None):
    """Raw expert stacks on UNFOLDED operands (a [*lead, E, M, K], counts
    [*lead, E]): one batched einsum per stream in the activation dtype,
    the epilogue chain, and the ragged contract as an output mask (the
    product is row-local, so masking the output alone establishes it)."""
    acc = torch.einsum("...emk,ekn->...emn", a, w)
    acc2 = (torch.einsum("...emk,ekn->...emn", a, w2)
            if w2 is not None else None)
    epi = spec.epilogue.with_bias(bias is not None)
    out = epi.apply(acc, bias=None if bias is None else bias[:, None, :],
                    gate=acc2).to(spec.resolved_out_dtype(a))
    if counts is not None:
        mask = ragged_row_mask(out.shape[-2], counts)[..., None]
        out = torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    return out


ctr.register_lowering(
    "grouped_einsum", "grouped",
    supports=lambda spec: spec.weight == "raw",
    cost=lambda spec: 0.0,
    run=_run_grouped_einsum, folds=False)


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
             bias=None, counts=None,
             strategy: Optional[str] = None) -> torch.Tensor:
    """Execute a declared contraction. Dense: ``a`` is [*lead, K]; leading
    dims fold into M for the lowering and are restored on the way out.
    Grouped: ``a`` is [*lead, E, M, K] with ``counts`` [*lead, E] for a
    ragged spec and ``w2`` the gate-mul partner; folding lowerings see the
    expert-major form (:func:`fold_grouped`)."""
    _check_operands(spec, w, w2, bias, counts)
    low = dispatch(spec, strategy=strategy)
    if spec.kind == "dense":
        lead = a.shape[:-1]
        out = low.run(spec, a.reshape(-1, a.shape[-1]), w, bias=bias)
        return out.reshape(*lead, out.shape[-1])
    if not low.folds:
        return low.run(spec, a, w, w2=w2, bias=bias, counts=counts)
    x3, fc, restore = fold_grouped(a, counts)
    return restore(low.run(spec, x3, w, w2=w2, bias=bias, counts=fc))


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


__all__ = ["contract", "dispatch", "fold_grouped", "linear",
           "ContractionSpec"]
