"""Declarative run-spec model: bench x model config x topology x parameters.

A :class:`RunSpec` DECLARES what to measure — which bench, over which model
configs, on which :class:`Topology` (mesh shape / device count / backend /
host count), with which parameter grid. :func:`expand` turns a set of specs
into a :class:`Plan` of concrete :class:`Job` records (one job per cell of
the config x topology x params grid), and the executors in
``repro_torch.harness.executor`` run (or emit manifests for) those jobs.
Nothing in here imports torch: the spec layer is pure data so manifest
generation and plan expansion are exercisable on any machine, card or not.

Topology is the unit the regression baselines key on: a committed
``BENCH_*.smoke.json`` stores per-:attr:`Topology.key` result sets and the
checker compares a fresh run ONLY against its own topology's baseline (see
``repro_torch.harness.baselines``).

This is the port of the JAX package's ``harness/spec.py`` with the same
names and fields. Its backends are ``cpu`` and ``cuda``; a one-host job on
either runs in-process, and the local topology is the card (``cuda:1``):
the port's entry points run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Topology", "LOCAL_TOPOLOGY", "TOPOLOGIES", "RunSpec", "Job",
           "Plan", "expand"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where a job runs: backend, logical mesh shape, and host count.

    ``mesh`` mirrors the shapes ``repro_torch.launch.mesh`` builds — ``(1,)``
    for the local single-device run, ``(16, 16)`` for one pod, ``(2, 16,
    16)`` for two. :attr:`key` is the stable string the per-topology
    baselines and the manifest labels use; two topologies with the same
    backend and mesh are the same measurement environment for regression
    purposes.
    """

    name: str
    backend: str = "cuda"         # "cpu" | "cuda"
    mesh: Tuple[int, ...] = (1,)
    hosts: int = 1

    def __post_init__(self):
        object.__setattr__(self, "mesh", tuple(int(d) for d in self.mesh))
        if not self.mesh or any(d < 1 for d in self.mesh):
            raise ValueError(f"invalid mesh {self.mesh!r}")
        if self.hosts < 1:
            raise ValueError(f"invalid hosts {self.hosts!r}")

    @property
    def devices(self) -> int:
        return math.prod(self.mesh)

    @property
    def key(self) -> str:
        """Baseline/manifest key: ``<backend>:<mesh dims 'x'-joined>``."""
        return f"{self.backend}:{'x'.join(str(d) for d in self.mesh)}"

    def is_local(self) -> bool:
        """Runnable in this process (single host, on the CPU or on this
        host's card)? Anything else is routed to the manifest-emitting
        executor."""
        return self.hosts == 1 and self.backend in ("cpu", "cuda")


LOCAL_TOPOLOGY = Topology(name="local-cuda")

# Named topologies the CLI accepts via --topology. The H100 entries mirror
# launch.mesh.make_production_mesh's (16,16) / (2,16,16) shapes at 8 GPUs a
# host (roofline.hw's gpus_per_node).
TOPOLOGIES: Dict[str, Topology] = {
    "local-cuda": LOCAL_TOPOLOGY,
    "local-cpu": Topology(name="local-cpu", backend="cpu"),
    "h100-pod": Topology(name="h100-pod", backend="cuda", mesh=(16, 16),
                         hosts=32),
    "h100-2pod": Topology(name="h100-2pod", backend="cuda",
                          mesh=(2, 16, 16), hosts=64),
}


def _as_params(params) -> Tuple[Tuple[str, Tuple], ...]:
    """Normalize a params mapping/iterable to a hashable sorted tuple of
    ``(name, (value, ...))`` pairs."""
    if not params:
        return ()
    items = params.items() if hasattr(params, "items") else params
    out = []
    for name, values in items:
        if isinstance(values, (str, bytes)) or not isinstance(
                values, Iterable):
            values = (values,)
        out.append((str(name), tuple(values)))
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One bench's declaration: what to run, where, and how to guard it.

    ``module``/``entry`` name the callable the local executor imports
    (``fn`` short-circuits that for in-test specs). ``artifact`` is the
    ``BENCH_<artifact>`` basename the bench writes — the regression guard
    keys on it; None means unguarded. ``smoke`` marks membership in the CI
    smoke tier; ``order`` fixes cross-bench execution order. ``configs`` /
    ``topologies`` / ``params`` span the expansion grid (empty configs ==
    one unparameterized job).
    """

    bench: str
    module: str = ""
    entry: str = "main"
    fn: Optional[Callable] = None
    artifact: Optional[str] = None
    smoke: bool = False
    order: int = 100
    configs: Tuple[str, ...] = ()
    topologies: Tuple[Topology, ...] = (LOCAL_TOPOLOGY,)
    params: Tuple[Tuple[str, Tuple], ...] = ()
    timeout_s: Optional[float] = 600.0
    max_retries: int = 2

    def __post_init__(self):
        if not self.bench:
            raise ValueError("RunSpec.bench must be non-empty")
        if not self.module and self.fn is None:
            raise ValueError(
                f"RunSpec {self.bench!r} needs a module or a fn")
        if isinstance(self.configs, str):
            object.__setattr__(self, "configs", (self.configs,))
        else:
            object.__setattr__(self, "configs", tuple(self.configs))
        if isinstance(self.topologies, Topology):
            object.__setattr__(self, "topologies", (self.topologies,))
        else:
            object.__setattr__(self, "topologies", tuple(self.topologies))
        if not self.topologies:
            raise ValueError(f"RunSpec {self.bench!r} needs >=1 topology")
        object.__setattr__(self, "params", _as_params(self.params))
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def param_grid(self) -> List[Dict[str, object]]:
        """Every parameter assignment in the declared grid (one empty dict
        when no params are declared)."""
        grid: List[Dict[str, object]] = [{}]
        for name, values in self.params:
            grid = [{**g, name: v} for g in grid for v in values]
        return grid


@dataclasses.dataclass
class Job:
    """One concrete cell of a spec's grid: the unit executors run."""

    name: str
    spec: RunSpec
    topology: Topology
    config: Optional[str] = None
    params: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def bench(self) -> str:
        return self.spec.bench

    @property
    def artifact(self) -> Optional[str]:
        return self.spec.artifact

    @property
    def timeout_s(self) -> Optional[float]:
        return self.spec.timeout_s

    @property
    def max_retries(self) -> int:
        return self.spec.max_retries

    def resolve_fn(self) -> Callable:
        """The callable the local executor invokes (import deferred to run
        time so plan expansion / manifest emission never import bench
        code)."""
        if self.spec.fn is not None:
            return self.spec.fn
        import importlib
        mod = importlib.import_module(self.spec.module)
        return getattr(mod, self.spec.entry)

    def call_kwargs(self, fn: Callable) -> Dict[str, object]:
        """The subset of (config + params) the callable accepts. Bench
        ``main()`` functions take nothing; parameterized jobs declare what
        they consume by naming it in their signature (or ``**kwargs``). A
        callable that names a ``device`` parameter also gets the
        topology's backend there (``"cuda"`` or ``"cpu"``)."""
        import inspect
        sig = inspect.signature(fn)
        accepts_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
        candidates = dict(self.params)
        if self.config is not None:
            candidates["config"] = self.config
        if accepts_kw:
            out = candidates
        else:
            out = {k: v for k, v in candidates.items()
                   if k in sig.parameters}
        if "device" in sig.parameters:
            out["device"] = self.topology.backend
        return out

    def as_dict(self) -> dict:
        return {"name": self.name, "bench": self.bench,
                "config": self.config, "topology": self.topology.key,
                "params": dict(self.params)}


@dataclasses.dataclass(frozen=True)
class Plan:
    """An expanded run: the specs it came from and the concrete jobs."""

    specs: Tuple[RunSpec, ...]
    jobs: Tuple[Job, ...]
    smoke: bool = False


def _job_name(spec: RunSpec, config: Optional[str], topo: Topology,
              params: Dict[str, object]) -> str:
    parts = [spec.bench]
    if config is not None:
        parts.append(config)
    if topo.key != LOCAL_TOPOLOGY.key or len(spec.topologies) > 1:
        parts.append(topo.name)
    parts.extend(f"{k}{v}" for k, v in sorted(params.items()))
    return "--".join(parts)


def expand(specs: Iterable[RunSpec], *, smoke: bool = False,
           benches: Optional[Iterable[str]] = None,
           topology: Optional[Topology] = None) -> Plan:
    """Expand specs into a :class:`Plan` of concrete jobs.

    ``smoke`` keeps only smoke-tier specs; ``benches`` filters by bench
    name (unknown names are a hard error — a typo'd filter must not
    silently run nothing); ``topology`` overrides every spec's declared
    topologies (the CLI's --topology escape hatch for manifest generation).
    """
    specs = tuple(sorted(specs, key=lambda s: (s.order, s.bench)))
    if benches is not None:
        benches = set(benches)
        known = {s.bench for s in specs}
        unknown = benches - known
        if unknown:
            raise KeyError(f"unknown bench(es) {sorted(unknown)}; "
                           f"registered: {sorted(known)}")
        specs = tuple(s for s in specs if s.bench in benches)
    if smoke:
        specs = tuple(s for s in specs if s.smoke)
    jobs: List[Job] = []
    seen = set()
    for spec in specs:
        topologies = (topology,) if topology is not None else spec.topologies
        for config in spec.configs or (None,):
            for topo in topologies:
                for params in spec.param_grid():
                    name = _job_name(spec, config, topo, params)
                    if name in seen:
                        raise ValueError(f"duplicate job name {name!r}")
                    seen.add(name)
                    jobs.append(Job(name=name, spec=spec, topology=topo,
                                    config=config, params=params))
    return Plan(specs=specs, jobs=tuple(jobs), smoke=smoke)
