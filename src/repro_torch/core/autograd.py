"""The gradient of a kernel contraction.

On the card a raw-weight dense contraction runs ``tiling`` (K7 on the
strided operands) or ``tiling_packing_fused`` (K5 packs B per call, then
K1): ctypes launches into tensors made by ``torch.empty``, which autograd
cannot see through. :class:`KernelContraction` wraps every such lowering
(every dense raw-weight lowering but ``torch_matmul``, whose own autograd
is the plain version) whenever grad is enabled and an operand requires it;
``core.gemm.contract`` enters it.

Forward: the dispatched lowering, as without a gradient. Where the
epilogue has an activation, the lowering stores the pre-activation ``z =
alpha * A @ W + beta * C + bias`` in f32 instead and the activation runs
in torch on it (the value the fused store epilogue computes: the
activation of the f32 accumulator, then one cast). ``z`` is saved for the
backward, which then needs no second forward product.

Backward, with ``g = dY * act'(z)`` (act' from torch's autograd of the
kernels' own activation table, so gelu is the tanh form):
``dA = alpha * g @ W^T``, ``dW = alpha * A^T @ g``, ``dbias = sum_rows(g)``,
``dC = beta * g``. Both products go through ``core.gemm.matmul`` with the
forward's strategy, so on the card they launch the kernels. ``A^T`` is a
transposed view, which K1 refuses (it needs A with unit column stride):
where the dispatch picks ``tiling_packing_fused`` for ``dW``, ``A^T`` is
copied contiguous first. That copy plus K5 + K1 ran a full-width olmo-1b
step's dW products 2.3-2.9x faster on an H100 than ``tiling`` (K7's
``mma_general`` reading the view), as the ``cuda`` test
``test_cuda_dw_copy_route_beats_k7_on_the_view`` times it.

Packed and grouped kernel lowerings have no backward here: a call that
needs a gradient through one raises (:func:`check_differentiable`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.epilogue import ACTIVATIONS

# The lowerings whose forward is plain torch, differentiated as it is.
NATIVE_LOWERINGS = ("torch_matmul", "grouped_einsum")


def _tensors(x):
    if x is None:
        return []
    if torch.is_tensor(x):
        return [x]
    return [t for t in (getattr(x, "packed", None), getattr(x, "scales", None))
            if t is not None]


def needs_grad(*operands) -> bool:
    """Whether grad is enabled and any operand (a tensor, or a packed
    weight's buffers) requires it."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for x in operands for t in _tensors(x))


def wraps(spec, low) -> bool:
    """Whether :class:`KernelContraction` carries this call's gradient."""
    return (spec.kind == "dense" and spec.weight == "raw"
            and low.name not in NATIVE_LOWERINGS)


def check_differentiable(spec, low) -> None:
    """Raise for a lowering that needs a gradient and has none."""
    if wraps(spec, low) or low.name in NATIVE_LOWERINGS:
        return
    raise RuntimeError(
        f"lowering {low.name!r} has no backward ({spec.describe()}): a "
        f"packed or grouped kernel contraction cannot carry a gradient yet "
        f"(MoE training on the card, gradients through K2 / K3, is an open "
        f"item of ROADMAP.md Queue 1); train with raw weights, or run the "
        f"call under torch.no_grad()")


def _act_grad(act: str, z: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dY * act'(z) in f32, by autograd of the activation table."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(ACTIVATIONS[act](zz),
                                   zz, dy.to(torch.float32))
    return g


def dw_strategy(a: torch.Tensor, g: torch.Tensor,
                strategy: Optional[str]) -> tuple:
    """``(operand A^T, strategy)`` for ``dW = A^T @ g``: the dispatch's
    pick for the product, with ``A^T`` made contiguous where that pick is
    K1 (``tiling_packing_fused``), which refuses the transposed view."""
    from repro_torch.core import gemm
    at = a.t()
    name = gemm.resolve_strategy(at.shape[0], at.shape[1], g.shape[1],
                                 a.dtype, strategy or "auto",
                                 on_card=a.is_cuda)
    if name == "tiling_packing_fused":
        return at.contiguous(), name
    return at, name


def weight_grad(a: torch.Tensor, g: torch.Tensor, *, alpha: float = 1.0,
                strategy: Optional[str] = None,
                out_dtype=None) -> torch.Tensor:
    """``alpha * A^T @ g`` through ``core.gemm.matmul`` (A [M, K], g
    [M, N] -> [K, N])."""
    from repro_torch.core import gemm
    at, name = dw_strategy(a, g, strategy)
    return gemm.matmul(at, g.to(a.dtype), alpha=alpha, strategy=name,
                       out_dtype=out_dtype)


class KernelContraction(torch.autograd.Function):
    """``out = act(alpha * a @ w + beta * c + bias)`` by a kernel lowering,
    with its gradient through the same lowerings (module docstring). ``a``
    is the folded [M, K] activation, ``w`` the raw [K, N] weight."""

    @staticmethod
    def forward(ctx, a, w, bias, c, low, spec, alpha, beta, plan, strategy):
        act = spec.epilogue.activation
        kw = dict(bias=bias, c=c, alpha=alpha, beta=beta, plan=plan)
        z = None
        if act == "none":
            out = low.run(spec, a, w, **kw)
        else:
            pre = dataclasses.replace(
                spec, out_dtype="float32",
                epilogue=dataclasses.replace(spec.epilogue, activation="none"))
            z = low.run(pre, a, w, **kw)
            out = ACTIVATIONS[act](z).to(spec.resolved_out_dtype(a, c))
        ctx.save_for_backward(a, w, z)
        ctx.act, ctx.alpha, ctx.beta, ctx.strategy = act, alpha, beta, strategy
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.c_dtype = None if c is None else c.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.core import gemm
        a, w, z = ctx.saved_tensors
        g = (dy if ctx.act == "none" else _act_grad(ctx.act, z, dy)).contiguous()
        need_a, need_w, need_bias, need_c = ctx.needs_input_grad[:4]
        da = dw = dbias = dc = None
        if need_a:
            da = gemm.matmul(g.to(w.dtype), w.t(), alpha=ctx.alpha,
                             strategy=ctx.strategy or "auto",
                             out_dtype=a.dtype)
        if need_w:
            dw = weight_grad(a, g, alpha=ctx.alpha, strategy=ctx.strategy,
                             out_dtype=w.dtype)
        if need_bias:
            dbias = g.to(torch.float32).sum(0).to(ctx.bias_dtype)
        if need_c:
            dc = (ctx.beta * g.to(torch.float32)).to(ctx.c_dtype)
        return da, dw, dbias, dc, None, None, None, None, None, None
