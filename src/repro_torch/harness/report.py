"""The machine-readable outcome of one harness run.

One :class:`HarnessReport` per run: per-job status/retry/timing rows, every
regression-guard verdict, a dispatch-health-registry snapshot, and the
counters ``--check`` derives its exit code from. Written as
``harness_report.json`` into the run directory (never the repo root), so a
red guard is diagnosable without replaying the run.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List

__all__ = ["HarnessReport"]


@dataclasses.dataclass
class HarnessReport:
    """Everything one run produced, JSON-serializable via :meth:`as_dict`.

    ``jobs`` rows are ``JobResult.as_dict()`` payloads (status, attempts,
    retries, backoffs, failure_class, timed_out, artifact/log/manifest
    paths); ``regressions`` rows are the baseline checker's verdicts (pass
    AND fail); ``counters`` aggregates both; ``health`` is the
    dispatch-health registry snapshot at run end (empty == healthy).
    """

    run_id: str
    run_dir: str
    smoke: bool
    check: bool
    tolerance: float
    jobs: List[dict] = dataclasses.field(default_factory=list)
    regressions: List[dict] = dataclasses.field(default_factory=list)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    health: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def failures(self) -> int:
        return (self.counters.get("failed", 0)
                + self.counters.get("regression_failures", 0))

    @property
    def exit_code(self) -> int:
        return 1 if self.failures else 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["failures"] = self.failures
        d["exit_code"] = self.exit_code
        return d

    def write(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.as_dict(), indent=2) + "\n")
        return path
