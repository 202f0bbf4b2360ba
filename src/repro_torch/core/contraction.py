"""Declarative contraction API (dense half): ContractionSpec + the lowering
registry + the one dispatch point.

Every contraction is declared as a frozen :class:`ContractionSpec`; each
lowering registers ``supports(spec)`` and a cost hint; :func:`dispatch`
chooses with the one precedence rule explicit > env
(``REPRO_TORCH_GEMM_STRATEGY``) > auto. Grouped contractions (MoE) and the
guarded fallback chain come with later slices of the port: here a failing
lowering raises.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.dtypes import dtype_name, torch_dtype
from repro_torch.core.epilogue import EpilogueSpec, as_epilogue_spec
from repro_torch.core.tile_format import TileFormat

_ENV_STRATEGY = "REPRO_TORCH_GEMM_STRATEGY"

KINDS = ("dense",)
WEIGHT_KINDS = ("raw", "packed")
ACCUMS = ("native", "f32")


def weight_kind(w) -> str:
    """"packed" for load-time-packed weights (they declare it), else "raw"."""
    return getattr(w, "weight_kind", "raw")


def is_packed(w) -> bool:
    return weight_kind(w) == "packed"


def weight_format(w) -> Optional[TileFormat]:
    return w.fmt if is_packed(w) else None


def as_compute_weight(w, dtype):
    """Raw weights cast to the compute dtype; packed ones pass through."""
    return w if is_packed(w) else w.to(dtype)


@dataclasses.dataclass(frozen=True)
class ContractionSpec:
    """One declared dense contraction ``out = epilogue(a @ w)``: folded
    geometry, dtypes, weight kind (+ packed format), accumulation contract
    and store chain."""

    kind: str
    m: int
    k: int
    n: int
    dtype: str = "float32"
    out_dtype: Optional[str] = None
    weight: str = "raw"
    b_format: Optional[TileFormat] = None
    accum: str = "native"
    epilogue: EpilogueSpec = EpilogueSpec()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}; got {self.kind!r}")
        if self.weight not in WEIGHT_KINDS:
            raise ValueError(
                f"weight must be one of {WEIGHT_KINDS}; got {self.weight!r}")
        if self.accum not in ACCUMS:
            raise ValueError(f"accum must be one of {ACCUMS}; got {self.accum!r}")
        if self.epilogue.gate_mul:
            raise ValueError("gate_mul is a grouped-only epilogue (the MoE "
                             "gate/up pair)")

    @classmethod
    def dense(cls, m: int, k: int, n: int, dtype, *, w=None, epilogue=None,
              bias: bool = False, out_dtype=None,
              accum: str = "native") -> "ContractionSpec":
        epi = as_epilogue_spec(epilogue)
        epi = epi.with_bias(epi.bias or bias)
        return cls(kind="dense", m=int(m), k=int(k), n=int(n),
                   dtype=dtype_name(dtype),
                   out_dtype=dtype_name(out_dtype) if out_dtype else None,
                   weight=weight_kind(w), b_format=weight_format(w),
                   accum=accum, epilogue=epi)

    def resolved_out_dtype(self, a, c=None) -> torch.dtype:
        if self.out_dtype is not None:
            return torch_dtype(self.out_dtype)
        return c.dtype if c is not None else a.dtype

    def describe(self) -> str:
        """Stable one-line key for dispatch tables and serving reports."""
        fmt = "" if self.b_format is None else f"|{self.b_format.dtype}-tiles"
        acc = f"|accum={self.accum}" if self.accum != "native" else ""
        epi = "+".join(self.epilogue.steps) or "none"
        return (f"{self.kind}[{self.m}x{self.k}x{self.n}]{self.dtype}"
                f"|{self.weight}{fmt}{acc}|epi={epi}")


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One registered lowering: ``run(spec, a, w, *, bias)`` on a folded
    [M, K] activation."""

    name: str
    kind: str
    supports: Callable[[ContractionSpec], bool]
    cost: Callable[[ContractionSpec], float]
    run: Callable


LOWERINGS: Dict[str, Lowering] = {}


def register_lowering(name: str, kind: str, *, supports, cost,
                      run) -> Lowering:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}; got {kind!r}")
    if name in LOWERINGS:
        raise ValueError(f"lowering {name!r} already registered")
    low = Lowering(name=name, kind=kind, supports=supports, cost=cost, run=run)
    LOWERINGS[name] = low
    return low


def _ensure_registered() -> None:
    if not LOWERINGS:
        import repro_torch.core.gemm  # noqa: F401  (registration side effect)


def lowerings_for(spec: ContractionSpec) -> Tuple[Lowering, ...]:
    _ensure_registered()
    return tuple(low for low in LOWERINGS.values()
                 if low.kind == spec.kind and low.supports(spec))


def dispatch(spec: ContractionSpec, *,
             strategy: Optional[str] = None) -> Lowering:
    """Choose THE lowering for a spec: explicit > env > auto (cheapest
    supporting lowering, ties by name)."""
    _ensure_registered()
    if strategy is not None and strategy != "auto":
        low = LOWERINGS.get(strategy)
        if low is None:
            raise KeyError(f"unknown lowering {strategy!r}; one of "
                           f"{sorted(LOWERINGS)}")
        if low.kind == spec.kind and low.supports(spec):
            return low
        raise ValueError(
            f"lowering {strategy!r} does not support {spec.describe()}")
    env = os.environ.get(_ENV_STRATEGY)
    if env and env != "auto":
        low = LOWERINGS.get(env)
        if low is None:
            raise KeyError(f"unknown lowering {env!r} ({_ENV_STRATEGY}); "
                           f"one of {sorted(LOWERINGS)}")
        if low.kind == spec.kind and low.supports(spec):
            return low
    cands = lowerings_for(spec)
    if not cands:
        raise ValueError(f"no registered lowering supports {spec.describe()}")
    return min(cands, key=lambda lw: (lw.cost(spec), lw.name))
