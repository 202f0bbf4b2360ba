"""Declarative benchmark/launch harness (ReFrame-style) of the PyTorch port.

The run-spec model: a :class:`RunSpec` declares bench x model config x
:class:`Topology` x parameters; :func:`expand` turns registered specs into
a :class:`Plan` of concrete jobs; an :class:`Executor` runs them —
:class:`LocalExecutor` in-process (per-job timeouts, capped-backoff
retries on classified failures, log capture) or :class:`ManifestExecutor`
emitting k8s-style job manifests for multi-host topologies; and
:func:`run_plan` assembles the machine-readable :class:`HarnessReport`
(per-job status/retries/timings, per-topology regression verdicts, health
snapshot) that ``--check`` derives its exit code from.

The port of the JAX package's ``harness`` with the same public surface
(``tests/test_torch_harness.py`` holds the two to each other). Its local
topology is this host's card (``local-cuda``, key ``cuda:1``); ``local-cpu``
runs in-process on the CPU; ``h100-pod`` / ``h100-2pod`` emit manifests.
``python -m repro_torch.harness`` is the CLI; it discovers the port's
benches as ``benchmarks/bench_torch_*.py``. Imports nothing of JAX.
"""
from repro_torch.harness.baselines import (REGRESSION_TOLERANCE,
                                           SCHEMA_VERSION, check_artifact,
                                           merge_topology_artifact, row_key,
                                           snapshot_baselines, speedup_fields,
                                           topology_payloads)
from repro_torch.harness.executor import (EXECUTORS, JOB_STATES,
                                          RETRYABLE_CLASSES, Executor,
                                          JobResult, JobTimeout,
                                          LocalExecutor, ManifestExecutor,
                                          job_manifest)
from repro_torch.harness.registry import (BENCHES, clear_registry,
                                          discover, register_bench,
                                          registered)
from repro_torch.harness.report import HarnessReport
from repro_torch.harness.runner import run_plan
from repro_torch.harness.spec import (LOCAL_TOPOLOGY, TOPOLOGIES, Job,
                                      Plan, RunSpec, Topology, expand)

__all__ = [
    # spec model
    "RunSpec", "Topology", "LOCAL_TOPOLOGY", "TOPOLOGIES", "Job", "Plan",
    "expand",
    # registry
    "BENCHES", "register_bench", "registered", "discover", "clear_registry",
    # executors
    "Executor", "LocalExecutor", "ManifestExecutor", "EXECUTORS",
    "JobResult", "JobTimeout", "JOB_STATES", "RETRYABLE_CLASSES",
    "job_manifest",
    # baselines / regression guard
    "REGRESSION_TOLERANCE", "SCHEMA_VERSION", "snapshot_baselines",
    "topology_payloads", "merge_topology_artifact", "check_artifact",
    "row_key", "speedup_fields",
    # report + runner
    "HarnessReport", "run_plan",
]
