"""Executors: how a :class:`~repro_torch.harness.spec.Job` actually runs.

Two implementations behind one interface:

  * :class:`LocalExecutor` — runs the job's callable in-process with a
    per-job timeout, capped-exponential-backoff retries on CLASSIFIED
    failures (``repro_torch.core.health.classify_failure`` — the same
    classifier the guarded dispatch and serving layers use, so an injected
    ``REPRO_FAULT=harness_job`` fault retries exactly like a real runtime
    failure, and a CUDA out-of-memory error like a resource failure), and
    per-job log capture into the run directory. A job that exhausts its
    retries is marked ``failed`` and the run CONTINUES — one poisoned bench
    never kills its siblings.
  * :class:`ManifestExecutor` — the multi-host stub: emits a k8s-style Job
    manifest per job (backoffLimit/activeDeadlineSeconds mirroring the
    spec's retry/timeout budget, resource requests from the topology:
    ``nvidia.com/gpu`` a host for a ``cuda`` topology) instead of
    executing, so cluster targets are exercised in tests and CI without a
    cluster. :func:`job_manifest` is the pure function that makes a
    manifest, which the golden test pins.

Timeouts in the local executor are COOPERATIVE: the callable runs to
completion and the elapsed time (injectable ``clock``) is checked after —
deterministically testable with a ``VirtualClock``, honest about the fact
that an in-process job cannot be preempted. The manifest executor encodes
the same budget as ``activeDeadlineSeconds``, where the cluster CAN
preempt. A timed-out attempt is retried like a transient failure (a
throttled runner is the common cause); persistent slowness exhausts the
retry budget and fails the job with ``timed_out`` set.

On a ``cuda`` topology the local executor runs on this host's card. With no
card the job fails as ``unsupported`` before its first attempt, its
callable never called: nothing runs on the CPU in the card's place. Each
attempt synchronises the card before the clock is read, so ``duration_s``
and the timeout count the card's work and not only its enqueueing, and an
asynchronous CUDA error fails the attempt that caused it. ``torch`` is
imported by the local route only (the port's health and fault modules, and
``torch.cuda`` on a ``cuda`` topology): plan expansion and manifest
emission stay pure data.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import sys
import time
from typing import List, Optional, Tuple

from repro_torch.harness.spec import Job

__all__ = ["RETRYABLE_CLASSES", "JOB_STATES", "JobTimeout", "JobResult",
           "Executor", "LocalExecutor", "ManifestExecutor", "EXECUTORS",
           "job_manifest"]

# Failure classes worth a retry (transient-shaped), matching the serving
# front-end's retry posture plus the harness-level timeout class.
RETRYABLE_CLASSES = ("compile", "resource", "runtime", "timeout")

# completed: ran and succeeded. failed: ran and exhausted its retry budget
# (or hit a non-retryable class). emitted: manifest written, not executed.
JOB_STATES = ("completed", "failed", "emitted")


class JobTimeout(RuntimeError):
    """An attempt exceeded the job's timeout budget (cooperative check)."""


@dataclasses.dataclass
class JobResult:
    """One job's outcome — the per-job row of the HarnessReport."""

    name: str
    bench: str
    topology: str                       # Topology.key
    status: str                         # one of JOB_STATES
    executor: str = "local"
    attempts: int = 0
    retries: int = 0                    # attempts that failed retryably
    duration_s: float = 0.0             # last attempt's wall time
    failure_class: Optional[str] = None
    detail: str = ""
    timed_out: bool = False
    backoffs: Tuple[float, ...] = ()
    artifact: Optional[str] = None      # collected artifact path (run dir)
    log: Optional[str] = None           # captured stdout/stderr path
    manifest: Optional[str] = None      # emitted manifest path

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["backoffs"] = list(self.backoffs)
        return d


class Executor:
    """Interface: run one job, never raise for job-level failures."""

    name = "abstract"

    def run(self, job: Job) -> JobResult:
        raise NotImplementedError


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self._streams = streams

    def write(self, s):
        for st in self._streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self._streams:
            st.flush()


def _missing_card() -> Optional[str]:
    """Why a ``cuda`` job cannot run here (None when a card is present)."""
    import torch
    if torch.cuda.is_available():
        return None
    return ("no CUDA device: torch.cuda.is_available() is false, and a "
            "cuda job does not run on the CPU in its place")


def _synchronize() -> None:
    """Wait for the card's work (a ``cuda`` job's attempt)."""
    import torch
    torch.cuda.synchronize()


class LocalExecutor(Executor):
    """In-process executor with classified retries and log capture.

    ``clock``/``sleep`` are injectable (default wall clock) — pass a
    ``repro_torch.serve.frontend.VirtualClock`` as both for deterministic
    retry/timeout tests. Backoff for attempt ``i`` (1-based) is
    ``min(backoff_base_s * 2**(i-1), backoff_cap_s)``.
    """

    name = "local"

    def __init__(self, run_dir=None, *, clock=time.monotonic,
                 sleep=time.sleep, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0):
        self.run_dir = pathlib.Path(run_dir) if run_dir else None
        self._clock = clock
        self._sleep = sleep
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)

    def _log_path(self, job: Job) -> Optional[pathlib.Path]:
        if self.run_dir is None:
            return None
        d = self.run_dir / "jobs"
        d.mkdir(parents=True, exist_ok=True)
        return d / f"{job.name}.log"

    def run(self, job: Job) -> JobResult:
        result = JobResult(name=job.name, bench=job.bench,
                           topology=job.topology.key, status="failed",
                           executor=self.name)
        log_path = self._log_path(job)
        if log_path is not None:
            result.log = str(log_path)
            with open(log_path, "w") as f:
                tee_out = _Tee(sys.stdout, f)
                tee_err = _Tee(sys.stderr, f)
                with contextlib.redirect_stdout(tee_out), \
                        contextlib.redirect_stderr(tee_err):
                    self._attempts(job, result)
        else:
            self._attempts(job, result)
        return result

    def _attempts(self, job: Job, result: JobResult) -> None:
        from repro_torch.core import health
        from repro_torch.testing import faults
        on_card = job.topology.backend == "cuda"
        if on_card:
            missing = _missing_card()
            if missing is not None:
                result.status = "failed"
                result.failure_class = "unsupported"
                result.detail = missing
                return
        backoffs: List[float] = []
        for attempt in range(1, job.max_retries + 2):
            result.attempts = attempt
            t0 = self._clock()
            try:
                faults.maybe_fail("harness_job")
                fn = job.resolve_fn()
                fn(**job.call_kwargs(fn))
                if on_card:
                    _synchronize()
                dt = self._clock() - t0
                if job.timeout_s is not None and dt > job.timeout_s:
                    raise JobTimeout(
                        f"attempt ran {dt:.3f}s > timeout {job.timeout_s}s")
                result.status = "completed"
                result.duration_s = dt
                result.retries = attempt - 1
                result.backoffs = tuple(backoffs)
                result.failure_class = None
                result.detail = ""
                return
            except Exception as exc:  # noqa: BLE001 — classified below
                dt = self._clock() - t0
                timed_out = isinstance(exc, JobTimeout)
                cls = ("timeout" if timed_out
                       else health.classify_failure(exc))
                result.duration_s = dt
                result.failure_class = cls
                result.detail = f"{type(exc).__name__}: {exc}"
                result.timed_out = result.timed_out or timed_out
                result.retries = attempt - 1
                if cls in RETRYABLE_CLASSES and attempt <= job.max_retries:
                    b = min(self.backoff_base_s * 2 ** (attempt - 1),
                            self.backoff_cap_s)
                    backoffs.append(b)
                    self._sleep(b)
                    continue
                result.status = "failed"
                result.retries = len(backoffs)
                result.backoffs = tuple(backoffs)
                return
        # Unreachable: the loop always returns.


def _k8s_name(name: str) -> str:
    """RFC-1123-ish label: lowercase alphanumerics and '-'."""
    out = "".join(c if c.isalnum() else "-" for c in name.lower())
    return out.strip("-")[:63] or "job"


def job_manifest(job: Job, *, smoke: bool = False) -> dict:
    """A k8s batch/v1 Job manifest for one harness job (pure function; the
    golden test pins this structure). Retry/timeout budgets map onto
    ``backoffLimit`` / ``activeDeadlineSeconds``; the topology maps onto
    parallelism (one pod per host) and per-pod accelerator requests."""
    topo = job.topology
    devices_per_host = max(1, topo.devices // topo.hosts)
    resource = ("nvidia.com/gpu" if topo.backend == "cuda"
                else "cpu")
    command = ["python", "-m", "repro_torch.harness", "--bench", job.bench]
    if smoke:
        command.append("--smoke")
    env = [{"name": "REPRO_BENCH_TOPOLOGY", "value": topo.key}]
    if smoke:
        env.insert(0, {"name": "REPRO_BENCH_SMOKE", "value": "1"})
    if job.config is not None:
        env.append({"name": "REPRO_BENCH_CONFIG", "value": job.config})
    for k, v in sorted(job.params.items()):
        env.append({"name": f"REPRO_BENCH_PARAM_{k.upper()}",
                    "value": str(v)})
    spec = {
        "backoffLimit": job.max_retries,
        "completions": topo.hosts,
        "parallelism": topo.hosts,
        "template": {
            "metadata": {"labels": {"app": "repro-bench"}},
            "spec": {
                "restartPolicy": "Never",
                "containers": [{
                    "name": "bench",
                    "image": "repro/bench:latest",
                    "command": command,
                    "env": env,
                    "resources": {
                        "limits": {resource: devices_per_host},
                    },
                }],
            },
        },
    }
    if job.timeout_s is not None:
        spec["activeDeadlineSeconds"] = int(job.timeout_s)
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": _k8s_name(f"repro-bench-{job.name}"),
            "labels": {"app": "repro-bench", "bench": _k8s_name(job.bench),
                       "topology": _k8s_name(topo.key)},
        },
        "spec": spec,
    }


class ManifestExecutor(Executor):
    """Multi-host stub: emit the job's manifest instead of executing it."""

    name = "manifest"

    def __init__(self, run_dir=None, *, smoke: bool = False):
        self.run_dir = pathlib.Path(run_dir) if run_dir else None
        self.smoke = smoke

    def run(self, job: Job) -> JobResult:
        manifest = job_manifest(job, smoke=self.smoke)
        path = None
        if self.run_dir is not None:
            d = self.run_dir / "manifests"
            d.mkdir(parents=True, exist_ok=True)
            path = d / f"{job.name}.manifest.json"
            path.write_text(json.dumps(manifest, indent=2) + "\n")
        return JobResult(
            name=job.name, bench=job.bench, topology=job.topology.key,
            status="emitted", executor=self.name, attempts=0,
            detail="manifest emitted (no cluster execution)",
            manifest=str(path) if path else None)


EXECUTORS = {"local": LocalExecutor, "manifest": ManifestExecutor}
