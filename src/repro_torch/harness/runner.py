"""Plan execution: route jobs to executors, collect artifacts/logs, guard
baselines, and assemble the :class:`~repro_torch.harness.report.HarnessReport`.

Routing is topology-aware: a job whose topology is locally runnable
(single host, on the CPU or on this host's card) executes in-process via
:class:`LocalExecutor`; any multi-host topology is handed to
:class:`ManifestExecutor`, which emits its k8s-style manifest into the run
directory instead — the same plan drives a local run and a cluster
submission path unchanged.

Artifact flow (smoke mode): the bench writes its legacy flat
``BENCH_*.smoke.json`` at the artifact root as always; after the job, the
runner rewrites it as a schema-2 topology-keyed payload (merging the
committed baseline's OTHER topology entries, so committing a regenerated
artifact never wipes baselines the run didn't re-measure) and copies it
into the run directory. ``check`` then compares the executed topology's
entry against the committed snapshot taken BEFORE the run.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Dict, Optional

from repro_torch.harness import baselines as bl
from repro_torch.harness.executor import (JobResult, LocalExecutor,
                                          ManifestExecutor)
from repro_torch.harness.report import HarnessReport
from repro_torch.harness.spec import Job, Plan

__all__ = ["run_plan"]


def _artifact_name(job: Job, smoke: bool) -> Optional[str]:
    if job.artifact is None:
        return None
    return f"{job.artifact}.smoke.json" if smoke else f"{job.artifact}.json"


def _collect_artifact(job: Job, result, *, root: pathlib.Path,
                      run_dir: Optional[pathlib.Path], smoke: bool,
                      committed: Optional[dict]) -> Optional[dict]:
    """Post-job artifact handling; returns the fresh payload (or None)."""
    name = _artifact_name(job, smoke)
    if name is None:
        return None
    path = root / name
    if not path.exists():
        return None
    try:
        fresh = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if smoke:
        # Topology-keyed rewrite (see module docstring).
        fresh = bl.merge_topology_artifact(fresh, job.topology.key,
                                           committed)
        path.write_text(json.dumps(fresh, indent=2) + "\n")
    if run_dir is not None:
        d = run_dir / "artifacts"
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy2(path, d / name)
        result.artifact = str(d / name)
    else:
        result.artifact = str(path)
    return fresh


def run_plan(plan: Plan, *, root, run_dir=None, run_id: Optional[str] = None,
             check: bool = False,
             committed_baselines: Optional[Dict[str, dict]] = None,
             tolerance: float = bl.REGRESSION_TOLERANCE,
             clock=time.monotonic, sleep=time.sleep,
             executor: Optional[str] = None,
             backoff_base_s: float = 0.05,
             backoff_cap_s: float = 1.0) -> HarnessReport:
    """Run every job in ``plan``; never raises for job failures.

    ``root`` is where benches write their artifacts (the repo root in the
    CLI). ``committed_baselines`` must be snapshotted BEFORE the run (the
    CLI does; tests may pass synthetic ones). ``executor`` forces "local"
    or "manifest" for every job instead of topology-aware routing.
    ``clock``/``sleep`` reach the local executor (VirtualClock in tests).
    """
    from repro_torch.core import health
    root = pathlib.Path(root)
    run_dir = pathlib.Path(run_dir) if run_dir is not None else None
    if run_dir is not None:
        run_dir.mkdir(parents=True, exist_ok=True)
    if committed_baselines is None:
        committed_baselines = {}
    run_id = run_id or time.strftime("run-%Y%m%dT%H%M%S")

    local = LocalExecutor(run_dir=run_dir, clock=clock, sleep=sleep,
                          backoff_base_s=backoff_base_s,
                          backoff_cap_s=backoff_cap_s)
    manifest = ManifestExecutor(run_dir=run_dir, smoke=plan.smoke)

    report = HarnessReport(
        run_id=run_id, run_dir=str(run_dir) if run_dir else "",
        smoke=plan.smoke, check=check, tolerance=tolerance)
    counters = {"jobs": len(plan.jobs), "completed": 0, "failed": 0,
                "emitted": 0, "retries": 0, "regression_failures": 0}

    for job in plan.jobs:
        if executor == "manifest":
            chosen = manifest
        elif executor == "local":
            chosen = local
        else:
            chosen = local if job.topology.is_local() else manifest
        try:
            result = chosen.run(job)
        except Exception as exc:  # noqa: BLE001 — a job must not kill the run
            result = JobResult(
                name=job.name, bench=job.bench, topology=job.topology.key,
                status="failed", executor=chosen.name, attempts=1,
                failure_class=health.classify_failure(exc),
                detail=f"{type(exc).__name__}: {exc}")
        counters[result.status] = counters.get(result.status, 0) + 1
        counters["retries"] += result.retries

        fresh = None
        if result.status == "completed":
            fresh = _collect_artifact(
                job, result, root=root, run_dir=run_dir, smoke=plan.smoke,
                committed=committed_baselines.get(_artifact_name(job, True)))
        if check and plan.smoke and job.artifact is not None \
                and result.status != "emitted":
            name = _artifact_name(job, True)
            failures, checks = bl.check_artifact(
                name, job.topology.key, fresh,
                committed_baselines.get(name), tolerance)
            counters["regression_failures"] += failures
            report.regressions.extend(checks)
        report.jobs.append(result.as_dict())

    report.counters = counters
    report.health = health.health_report()
    if run_dir is not None:
        report.write(run_dir / "harness_report.json")
    return report
