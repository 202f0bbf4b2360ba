"""Public contraction API of the port: :func:`contract` executes a declared
:class:`ContractionSpec` (validate -> dispatch -> fold -> run -> restore)
and :func:`linear` is the facade the model layers call.

Two dense lowerings are registered: ``packed_weight`` (load-time-packed
weights, the fused-A CUDA kernel on the card) and ``torch_matmul`` (raw
weights, plain torch, CPU only — on the card raw weights would lower to the
blocked kernel ``gemm_tiled``, which is not ported yet).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import contraction as ctr
from repro_torch.core.contraction import ContractionSpec, dispatch
from repro_torch.core.epilogue import as_epilogue_spec

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


def contract(spec: ContractionSpec, a: torch.Tensor, w, *, bias=None,
             strategy: Optional[str] = None) -> torch.Tensor:
    """Execute a declared contraction. ``a`` is [*lead, K]; leading dims
    fold into M for the lowering and are restored on the way out."""
    if ctr.weight_kind(w) != spec.weight:
        raise ValueError(f"weight kind {ctr.weight_kind(w)!r} != spec "
                         f"{spec.weight!r} ({spec.describe()})")
    if spec.epilogue.bias != (bias is not None):
        raise ValueError(f"spec declares bias={spec.epilogue.bias} but the "
                         f"bias operand is "
                         f"{'set' if bias is not None else 'missing'}")
    low = dispatch(spec, strategy=strategy)
    lead = a.shape[:-1]
    out = low.run(spec, a.reshape(-1, a.shape[-1]), w, bias=bias)
    return out.reshape(*lead, out.shape[-1])


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


__all__ = ["contract", "dispatch", "linear", "ContractionSpec"]
