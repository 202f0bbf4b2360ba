"""The ONE bench registry: every ``benchmarks/bench_torch_*.py`` registers
its own :class:`~repro_torch.harness.spec.RunSpec` at import time, and the
harness CLI discovers bench modules by filename pattern — adding a bench is
a ``register_bench(RunSpec(...))`` table entry in the new module, with zero
per-bench glue in the CLI.

The port's benches share the ``benchmarks`` namespace package with the JAX
package's, which all import JAX: discovery imports only the modules whose
name starts with ``prefix`` (``bench_torch_``), never a ``bench_*`` module
of the reference.
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, Tuple

from repro_torch.harness.spec import RunSpec

__all__ = ["BENCHES", "register_bench", "registered", "discover",
           "clear_registry"]

# The filename prefix of the port's bench modules.
BENCH_PREFIX = "bench_torch_"

BENCHES: Dict[str, RunSpec] = {}


def register_bench(spec: RunSpec) -> RunSpec:
    """Register (idempotently) one bench's spec. Re-registering the SAME
    spec is a no-op (modules may be re-imported); a conflicting spec under
    an existing name is a hard error — two benches must not silently fight
    over one registry slot."""
    existing = BENCHES.get(spec.bench)
    if existing is not None and existing != spec:
        raise ValueError(f"bench {spec.bench!r} already registered with a "
                         f"different spec")
    BENCHES[spec.bench] = spec
    return spec


def registered() -> Tuple[RunSpec, ...]:
    return tuple(sorted(BENCHES.values(), key=lambda s: (s.order, s.bench)))


def discover(package: str = "benchmarks", *,
             prefix: str = BENCH_PREFIX) -> Tuple[RunSpec, ...]:
    """Import every ``<prefix>*`` module in ``package`` so each registers
    its spec, then return the registry. Discovery is by filename pattern —
    registration stays in the bench module itself."""
    pkg = importlib.import_module(package)
    for info in sorted(pkgutil.iter_modules(pkg.__path__),
                       key=lambda i: i.name):
        if info.name.startswith(prefix):
            importlib.import_module(f"{package}.{info.name}")
    return registered()


def clear_registry() -> None:
    """Test isolation only."""
    BENCHES.clear()
