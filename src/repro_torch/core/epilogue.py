"""Fused GEMM store epilogues: what an epilogue IS, in one place.

``ACTIVATIONS`` is the activation table; :class:`EpilogueSpec` the ordered
chain ``(dequant ->) bias -> activation -> gate-mul`` applied to the f32
accumulator before the single store; ``EPILOGUE_SPECS`` the named specs.
The dequant stage is implied by a quantized
:class:`~repro_torch.core.tile_format.TileFormat`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.common import KERNEL_EPILOGUES

ACTIVATIONS: Dict[str, Callable] = KERNEL_EPILOGUES


def apply_epilogue(name: str, x: torch.Tensor) -> torch.Tensor:
    """Apply one activation stage by name (gelu is the tanh form, as every
    kernel's store epilogue computes it)."""
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown epilogue {name!r}; one of {list(ACTIVATIONS)}")
    return ACTIVATIONS[name](x)


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Declarative store epilogue: ``bias`` consumes a length-N bias,
    ``activation`` follows it, ``gate_mul`` multiplies by a second
    accumulator (the MoE gate/up pair; silu only)."""

    bias: bool = False
    activation: str = "none"
    gate_mul: bool = False

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}; "
                             f"one of {list(ACTIVATIONS)}")
        if self.gate_mul and self.activation != "silu":
            raise ValueError(
                "gate_mul composes with activation='silu' only; got "
                f"{self.activation!r}")

    @property
    def steps(self) -> Tuple[str, ...]:
        """The chain in application order (excluding the implied dequant)."""
        out = []
        if self.bias:
            out.append("bias")
        if self.activation != "none":
            out.append(self.activation)
        if self.gate_mul:
            out.append("gate_mul")
        return tuple(out)

    def with_bias(self, flag: bool = True) -> "EpilogueSpec":
        if flag == self.bias:
            return self
        return dataclasses.replace(self, bias=flag)

    @property
    def kernel_name(self) -> str:
        """The in-kernel epilogue name (bias lowers to an operand)."""
        return "silu_gate" if self.gate_mul else self.activation

    def apply(self, acc: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
              gate: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain application of the chain to an accumulator."""
        if self.bias != (bias is not None):
            raise ValueError(f"epilogue {self} expects bias={self.bias}")
        if self.gate_mul != (gate is not None):
            raise ValueError(f"epilogue {self} expects gate_mul={self.gate_mul}")
        if bias is not None:
            acc = acc + bias.to(acc.dtype)
        out = ACTIVATIONS[self.activation](acc)
        if gate is not None:
            out = out * gate
        return out


EPILOGUE_SPECS: Dict[str, EpilogueSpec] = {
    "none": EpilogueSpec(),
    "relu": EpilogueSpec(activation="relu"),
    "gelu": EpilogueSpec(activation="gelu"),
    "silu": EpilogueSpec(activation="silu"),
    "tanh": EpilogueSpec(activation="tanh"),
    "silu_gate": EpilogueSpec(activation="silu", gate_mul=True),
    "bias_gelu": EpilogueSpec(bias=True, activation="gelu"),
}


def as_epilogue_spec(ep) -> EpilogueSpec:
    """``EpilogueSpec | str | None`` -> :class:`EpilogueSpec`."""
    if ep is None:
        return EPILOGUE_SPECS["none"]
    if isinstance(ep, EpilogueSpec):
        return ep
    if not isinstance(ep, str):
        raise TypeError(f"epilogue must be an EpilogueSpec or name; got "
                        f"{type(ep).__name__}")
    if ep not in EPILOGUE_SPECS:
        raise KeyError(
            f"unknown epilogue {ep!r}; one of {list(EPILOGUE_SPECS)}")
    return EPILOGUE_SPECS[ep]
