"""Declarative contraction API: ContractionSpec + the lowering registry +
the one dispatch point, for dense and grouped (MoE expert) contractions.

Every contraction is declared as a frozen :class:`ContractionSpec`; each
lowering registers ``supports(spec)`` and a cost hint ``cost(spec,
on_card)``; :func:`dispatch` chooses with the one precedence rule explicit >
env (``REPRO_TORCH_GEMM_STRATEGY``, honoured only for a lowering of the
spec's kind that supports it) > auto. ``on_card`` says whether the operands
lie on the card, as the reference's ``kernel_backend()`` says whether it
targets the TPU: the auto pick there is the planner's kernel strategy, on
the CPU the plain torch lowerings.

Guarded execution (:func:`fallback_chain` + :func:`run_guarded`): env and
auto dispatch on the CPU never crash on a failing lowering. The runner
classifies the failure (``repro_torch.core.health``), records the
degradation in the health registry, and degrades down the chain of
supporting lowerings ordered by ``cost(spec, on_card)``, bottoming out at
the always-supporting plain torch reference lowerings
(:data:`REFERENCE_LOWERINGS`, cost :data:`REFERENCE_COST`: finite so they
sit at the chain's end, huge so auto never picks them outright). An
explicit ``strategy=`` choice is a contract and never degrades: it raises.

On the card the chain is the winner alone: a kernel wrapper given CUDA
tensors launches its kernel or raises, and no other lowering takes over
its work there. A failure that raises at the call (a kernel build error, a
launch refused by the wrapper's own checks, a geometry check,
``torch.cuda.OutOfMemoryError``) propagates with a note naming the spec and
the lowering, and the registry records nothing. An asynchronous device
fault (an illegal address, a trap in a kernel) surfaces at a later
synchronisation, far from the call that caused it, and leaves the context
unusable, so it ends the run in any case. The opt-in numerics guard
(``REPRO_NUMERICS_GUARD``) reads each output back, so it synchronises, and
on the card a non-finite output raises
:class:`~repro_torch.core.health.NumericsError`. An eager call is checked
every time. A served step on the card is a captured CUDA graph
(``serve.graphs``): the runner, its environment reads and the fault sites
of the lowerings run in the step's warm-up and capture passes only, never
on a replay, and the guard reads nothing back while the capture is under
way (``health.numerics_guard_active``), as the reference's guard decides
once, at trace time.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import health
from repro_torch.core.dtypes import dtype_name, torch_dtype
from repro_torch.core.epilogue import EpilogueSpec, as_epilogue_spec
from repro_torch.core.tile_format import TileFormat

_ENV_STRATEGY = "REPRO_TORCH_GEMM_STRATEGY"

KINDS = ("dense", "grouped")
WEIGHT_KINDS = ("raw", "packed")
ACCUMS = ("native", "f32")

# Cost of the comparison lowerings (the paper's slower strategies): runnable
# when named, never the auto pick, never in a fallback chain.
COMPARISON_COST = float("inf")

# Cost of the always-supporting reference lowerings: finite (they join the
# fallback chain, unlike the comparison lowerings) but far above every real
# contender, so auto dispatch never picks them while a kernel or library
# lowering supports the spec.
REFERENCE_COST = 1e9

# kind -> name of the always-supporting reference lowering, the bottom of
# every fallback chain (filled by repro_torch.core.strategy).
REFERENCE_LOWERINGS: Dict[str, str] = {}


def default_backend() -> str:
    """``"cuda"`` where ``torch.cuda.is_available()``, else ``"cpu"``.

    Informational only: dispatch reads each call's operand device
    (``on_card``), never this. The reference's ``REPRO_GEMM_BACKEND``
    override has no counterpart, since no environment variable may move
    the port's work off the card."""
    return "cuda" if torch.cuda.is_available() else "cpu"


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
    """One declared contraction ``out = epilogue(a @ w (* gate))``: dense
    (a [M, K] after folding) or grouped (a [E, M, K], ``m`` the per-expert
    rows after folding); dtypes, weight kind (+ packed format), whether
    valid-row ``counts`` accompany the call (ragged: rows at or past the
    count are padding, zero in the output), the expected ``occupancy`` of
    the padded rows, the accumulation contract and the store chain."""

    kind: str
    m: int
    k: int
    n: int
    e: int = 1
    dtype: str = "float32"
    out_dtype: Optional[str] = None
    weight: str = "raw"
    b_format: Optional[TileFormat] = None
    counts: bool = False
    occupancy: float = 1.0
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
        if self.kind == "dense":
            if self.e != 1:
                raise ValueError(f"dense contractions have e=1; got {self.e}")
            if self.counts:
                raise ValueError("counts (ragged) is a grouped-only contract")
            if self.epilogue.gate_mul:
                raise ValueError("gate_mul is a grouped-only epilogue (the "
                                 "MoE gate/up pair)")
        if not 0.0 < self.occupancy <= 1.0:
            raise ValueError(f"occupancy in (0, 1]; got {self.occupancy}")

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

    @classmethod
    def grouped(cls, e: int, m: int, k: int, n: int, dtype, *, w=None,
                epilogue=None, bias: bool = False, counts: bool = False,
                occupancy: Optional[float] = None,
                out_dtype=None) -> "ContractionSpec":
        """Grouped spec (``m`` = per-expert folded rows)."""
        epi = as_epilogue_spec(epilogue)
        epi = epi.with_bias(epi.bias or bias)
        return cls(kind="grouped", e=int(e), m=int(m), k=int(k), n=int(n),
                   dtype=dtype_name(dtype),
                   out_dtype=dtype_name(out_dtype) if out_dtype else None,
                   weight=weight_kind(w), b_format=weight_format(w),
                   counts=counts, occupancy=occupancy or 1.0, epilogue=epi)

    @property
    def b_dtype(self) -> Optional[str]:
        """B's element dtype where it differs from the compute dtype (a
        quantized format), for the planner's byte accounting."""
        if self.b_format is not None and self.b_format.is_quantized:
            return self.b_format.dtype
        return None

    def resolved_out_dtype(self, a, c=None) -> torch.dtype:
        if self.out_dtype is not None:
            return torch_dtype(self.out_dtype)
        return c.dtype if c is not None else a.dtype

    def describe(self) -> str:
        """Stable one-line key for dispatch tables and serving reports."""
        geo = (f"E{self.e}x" if self.kind == "grouped" else "") + \
            f"{self.m}x{self.k}x{self.n}"
        fmt = "" if self.b_format is None else f"|{self.b_format.dtype}-tiles"
        flags = "".join([
            "|counts" if self.counts else "",
            f"|occ={self.occupancy:g}" if self.occupancy != 1.0 else "",
            f"|accum={self.accum}" if self.accum != "native" else "",
        ])
        epi = "+".join(self.epilogue.steps) or "none"
        return (f"{self.kind}[{geo}]{self.dtype}"
                f"|{self.weight}{fmt}{flags}|epi={epi}")


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One registered lowering. Dense: ``run(spec, a, w, *, bias, c, alpha,
    beta, plan)`` on a folded [M, K] activation. Grouped: ``run(spec, a, w,
    *, w2, bias, counts)``; with ``folds`` it sees the expert-major [E, M,
    K] form and [E, S] counts, without it the caller's [*lead, E, M, K] and
    [*lead, E]. ``cost(spec, on_card)`` is the auto pick's preference (0 for
    the planner's choice). ``upgrade(spec)`` may name a more capable sibling
    for a spec this lowering cannot run (``grouped_packed`` on a spec with
    counts lands on ``grouped_packed_ragged``)."""

    name: str
    kind: str
    supports: Callable[[ContractionSpec], bool]
    cost: Callable[[ContractionSpec, bool], float]
    run: Callable
    folds: bool = True
    upgrade: Optional[Callable[[ContractionSpec], Optional[str]]] = None


LOWERINGS: Dict[str, Lowering] = {}


def register_lowering(name: str, kind: str, *, supports, cost, run,
                      folds: bool = True, upgrade=None) -> Lowering:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}; got {kind!r}")
    if name in LOWERINGS:
        raise ValueError(f"lowering {name!r} already registered")
    low = Lowering(name=name, kind=kind, supports=supports, cost=cost,
                   run=run, folds=folds, upgrade=upgrade)
    LOWERINGS[name] = low
    return low


def _ensure_registered() -> None:
    # Importing core.gemm registers the strategy lowerings; core.layered
    # alone registers only the packed ones, so test for a strategy's name.
    if "torch_matmul" not in LOWERINGS:
        import repro_torch.core.gemm  # noqa: F401  (registration side effect)


def lowerings_for(spec: ContractionSpec) -> Tuple[Lowering, ...]:
    _ensure_registered()
    return tuple(low for low in LOWERINGS.values()
                 if low.kind == spec.kind and low.supports(spec))


def dispatch(spec: ContractionSpec, *, strategy: Optional[str] = None,
             on_card: bool = False) -> Lowering:
    """Choose THE lowering for a spec: explicit > env > auto (cheapest
    supporting lowering by ``cost(spec, on_card)``, ties by name)."""
    _ensure_registered()

    def upgraded(low: Lowering) -> Optional[Lowering]:
        """A named lowering of the spec's kind, or its declared more
        capable sibling, if either supports the spec."""
        if low.kind != spec.kind:
            return None
        if low.supports(spec):
            return low
        name = low.upgrade(spec) if low.upgrade is not None else None
        if name is not None and LOWERINGS[name].supports(spec):
            return LOWERINGS[name]
        return None

    if strategy is not None and strategy != "auto":
        low = LOWERINGS.get(strategy)
        if low is None:
            raise KeyError(f"unknown lowering {strategy!r}; one of "
                           f"{sorted(LOWERINGS)}")
        chosen = upgraded(low)
        if chosen is not None:
            return chosen
        raise ValueError(
            f"lowering {strategy!r} does not support {spec.describe()}")
    env = os.environ.get(_ENV_STRATEGY)
    if env and env != "auto":
        low = LOWERINGS.get(env)
        if low is None:
            raise KeyError(f"unknown lowering {env!r} ({_ENV_STRATEGY}); "
                           f"one of {sorted(LOWERINGS)}")
        chosen = upgraded(low)
        if chosen is not None:
            return chosen
    cands = lowerings_for(spec)
    if not cands:
        raise ValueError(f"no registered lowering supports {spec.describe()}")
    return min(cands, key=lambda lw: (lw.cost(spec, on_card), lw.name))



# Exceptions that are control flow, not a lowering's failure: the guarded
# runner lets them through. Non-reentrant activation checkpointing stops a
# recomputation once it has every saved tensor back by raising this one from
# inside whatever runs at that moment, a contraction included.
_CONTROL_FLOW = tuple(
    t for t in (getattr(torch.utils.checkpoint, "_StopRecomputationError",
                        None),) if t is not None)


def fallback_chain(spec: ContractionSpec, chosen: Lowering, *,
                   on_card: bool = False) -> Tuple[Lowering, ...]:
    """The guarded-dispatch degradation order for ``spec``: ``chosen`` (the
    dispatch winner) first, then every other supporting lowering by
    ``(cost(spec, on_card), name)`` with the comparison lowerings left out,
    then the kind's reference lowering last. On the card the chain is
    ``chosen`` alone (see the module docstring)."""
    if on_card:
        return (chosen,)
    _ensure_registered()
    ref_name = REFERENCE_LOWERINGS.get(spec.kind)
    others = sorted(
        (lw for lw in lowerings_for(spec)
         if lw.name not in (chosen.name, ref_name)
         and lw.cost(spec, on_card) < COMPARISON_COST),
        key=lambda lw: (lw.cost(spec, on_card), lw.name))
    tail = (LOWERINGS[ref_name],) \
        if ref_name is not None and ref_name != chosen.name else ()
    return (chosen, *others) + tail


def run_guarded(spec: ContractionSpec, chosen: Lowering,
                run_one: Callable[[Lowering], torch.Tensor], *,
                on_card: bool = False,
                usable: Optional[Callable[[Lowering], bool]] = None
                ) -> torch.Tensor:
    """``run_one(chosen)``, degraded down ``fallback_chain(spec, chosen,
    on_card=on_card)`` (env / auto dispatch) when it fails.

    A failing lowering is classified (``health.classify_failure``), the
    degradation recorded in the health registry, and the next entry tried;
    with the numerics guard armed, a NaN / Inf output degrades the same way.
    The chain is built only after a failure, keeping the lowerings that
    ``usable`` accepts (those with a backward, for a call that needs a
    gradient). The last entry is never degraded past: its failure
    propagates, so a genuine contract violation still surfaces. On the card
    that entry is the winner: its failure propagates with a note naming the
    spec, and a non-finite output under the guard raises
    :class:`~repro_torch.core.health.NumericsError`.

    Inside a captured served step (``serve.graphs``) this runs at the
    warm-up and the capture only; a replay runs none of it, and during the
    capture the guard makes no read-back (``health.numerics_guard_active``)."""
    chain, i, low = None, 0, chosen
    while True:
        failure = None
        try:
            out = run_one(low)
        except _CONTROL_FLOW:
            raise
        except Exception as exc:  # noqa: BLE001 — classify, then degrade
            failure = exc
        if failure is None and not (health.numerics_guard_active()
                                    and health.has_nonfinite(out)):
            return out
        if chain is None:
            chain = fallback_chain(spec, chosen, on_card=on_card)
            if usable is not None:
                chain = tuple(lw for lw in chain if usable(lw))
        if i == len(chain) - 1:
            where = (f"{spec.describe()}: lowering {low.name!r} failed on the "
                     f"card, where no other lowering takes over")
            if failure is not None:
                if on_card:
                    failure.add_note(where)
                raise failure
            if on_card:
                raise health.NumericsError(
                    f"{where}: non-finite values in its output "
                    f"({health.ENV_NUMERICS_GUARD})")
            return out
        if failure is None:
            cause, detail = "numerics", "non-finite values in output"
        else:
            cause = health.classify_failure(failure)
            detail = f"{type(failure).__name__}: {failure}"
        health.record_degradation(spec.describe(), low.name, cause,
                                  chain[i + 1].name, detail=detail)
        i += 1
        low = chain[i]


def check_explicit_numerics(spec: ContractionSpec, low: Lowering,
                            out) -> None:
    """The explicit side of the numerics guard: an explicit choice never
    degrades, so under the guard a non-finite output raises."""
    if health.numerics_guard_active() and health.has_nonfinite(out):
        raise health.NumericsError(
            f"non-finite values in output of explicit lowering {low.name!r} "
            f"for {spec.describe()} ({health.ENV_NUMERICS_GUARD})")


def dispatch_table(specs, *, on_card: bool = False) -> Dict[str, str]:
    """``{spec.describe(): dispatch(spec).name}``: the golden-test and
    serving-report view of the dispatch surface."""
    return {spec.describe(): dispatch(spec, on_card=on_card).name
            for spec in specs}
