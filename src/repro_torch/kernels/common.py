"""Shared pieces of the port's GEMM kernels: the store-epilogue table, the
accumulator-dtype rule, the plain versions' accumulator and store epilogue,
and padding helpers.

``KERNEL_EPILOGUES`` is the plain-torch statement of what every kernel's
store epilogue computes on its f32 accumulator; the CUDA kernels carry the
same table as an ``act`` code (``EPILOGUE_CODES``). gelu is the tanh
approximation, as in the reference (``jax.nn.gelu(approximate=True)``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tile_format import cdiv  # noqa: F401  (re-exported)

KERNEL_EPILOGUES = {
    "none": lambda x: x,
    "relu": lambda x: torch.clamp_min(x, 0),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": lambda x: x * torch.sigmoid(x),
    "tanh": torch.tanh,
}

# The in-kernel activation codes (same order as the CUDA source's switch).
EPILOGUE_CODES = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}


def kernel_epilogue_name(epilogue) -> str:
    """``EpilogueSpec | str`` -> the in-kernel epilogue name."""
    name = getattr(epilogue, "kernel_name", epilogue)
    if name not in KERNEL_EPILOGUES:
        raise KeyError(f"unknown kernel epilogue {name!r}")
    return name


def pad2d(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor to multiples of (m0, m1)."""
    p0 = (-x.shape[0]) % m0
    p1 = (-x.shape[1]) % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype: i32 for integer inputs, f32 otherwise."""
    if not dtype.is_floating_point:
        return torch.int32
    return torch.float32


def plain_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on the accumulator type: f32 for float operands, i32 for
    integer ones. The integer product is summed in f64 (exact below 2^53),
    which the card's matmul supports where it has no i32 one."""
    if acc_dtype_for(a.dtype) == torch.int32:
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
            torch.int32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def finalize(acc: torch.Tensor, c, alpha: float, beta: float, bias, epilogue,
             out_dtype) -> torch.Tensor:
    """The reference's ``finalize_gemm`` on a finished accumulator: alpha,
    then beta * C, then bias, then the activation, then one cast. C and the
    bias are cast to the accumulator's type first (i32 for an integer
    product), and the arithmetic is f32, as an i32 accumulator times a
    Python float is in the reference."""
    out = alpha * acc.to(torch.float32)
    if c is not None and beta != 0:
        out = out + beta * c.to(acc.dtype).to(torch.float32)
    if bias is not None:
        out = out + bias.to(acc.dtype).to(torch.float32)
    return KERNEL_EPILOGUES[kernel_epilogue_name(epilogue)](out).to(out_dtype)
