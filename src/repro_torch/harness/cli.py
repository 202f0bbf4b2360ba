"""The port's harness CLI: ``python -m repro_torch.harness``.

    python -m repro_torch.harness --list                 # registered specs
    python -m repro_torch.harness --smoke --check        # the guard
    python -m repro_torch.harness --bench NAME           # one bench
    python -m repro_torch.harness --smoke --executor manifest --topology h100-pod

Flow: parse -> arm REPRO_BENCH_SMOKE -> snapshot committed baselines ->
discover bench specs (each ``bench_torch_*`` module of the ``benchmarks``
namespace package registers its own RunSpec; the JAX package's
``bench_*`` modules are never imported) -> expand the plan -> run it
(topology-aware executor routing: one-host jobs in-process, on the card
for ``cuda`` topologies) -> write the HarnessReport into the run directory
(``results/harness/<run-id>/``) and derive the exit code from it.

``--check`` requires ``--smoke``: the guard compares the ``*.smoke.json``
artifacts the run regenerates; a full run never rewrites them, so a bare
``--check`` would compare the committed baselines against themselves and
report success.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time
from typing import Optional

from repro_torch.harness import baselines as bl
from repro_torch.harness import registry
from repro_torch.harness.runner import run_plan
from repro_torch.harness.spec import TOPOLOGIES, expand

__all__ = ["main"]

ENV_SMOKE = "REPRO_BENCH_SMOKE"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.harness",
        description="Declarative benchmark/launch harness of the PyTorch "
                    "port (repro_torch.harness)")
    p.add_argument("--smoke", action="store_true",
                   help="quick CI tier: smoke-registered benches on "
                        "shrunken sizes (sets REPRO_BENCH_SMOKE=1)")
    p.add_argument("--check", action="store_true",
                   help="regression guard: compare fresh smoke speedups "
                        "against the committed per-topology baselines")
    p.add_argument("--bench", action="append", default=None,
                   metavar="NAME", help="run only the named bench(es)")
    p.add_argument("--run-dir", default=None,
                   help="run directory for the report, per-job logs, "
                        "collected artifacts and manifests "
                        "(default: results/harness/<run-id>)")
    p.add_argument("--executor", choices=("auto", "local", "manifest"),
                   default="auto",
                   help="force an executor instead of topology-aware "
                        "routing (auto: one-host topologies run "
                        "in-process, on the card for cuda ones; multi-host "
                        "topologies emit manifests)")
    p.add_argument("--topology", choices=sorted(TOPOLOGIES), default=None,
                   help="override every spec's topologies with one named "
                        "topology")
    p.add_argument("--list", action="store_true", dest="list_specs",
                   help="list registered bench specs and exit")
    return p


def main(argv=None, *, package: str = "benchmarks",
         prefix: str = registry.BENCH_PREFIX,
         root: Optional[pathlib.Path] = None) -> int:
    args = _parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.check and not args.smoke:
        print("--check requires --smoke (the guard compares the smoke "
              "artifacts the run regenerates)", file=sys.stderr)
        return 2
    root = pathlib.Path(root) if root is not None \
        else pathlib.Path.cwd()

    if args.smoke:
        os.environ[ENV_SMOKE] = "1"
    # Snapshot the committed baselines BEFORE any bench overwrites them —
    # both the guard and the topology-preserving artifact merge need the
    # pre-run state.
    committed = bl.snapshot_baselines(root) if args.smoke else {}

    specs = registry.discover(package, prefix=prefix)
    if args.list_specs:
        for spec in specs:
            topos = ",".join(t.key for t in spec.topologies)
            print(f"{spec.bench}  smoke={spec.smoke}  "
                  f"artifact={spec.artifact or '-'}  topologies={topos}")
        return 0

    try:
        plan = expand(specs, smoke=args.smoke, benches=args.bench,
                      topology=(TOPOLOGIES[args.topology]
                                if args.topology else None))
    except KeyError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not plan.jobs:
        print("error: plan expanded to zero jobs", file=sys.stderr)
        return 2

    run_id = time.strftime("run-%Y%m%dT%H%M%S")
    run_dir = (pathlib.Path(args.run_dir) if args.run_dir
               else root / "results" / "harness" / run_id)

    report = run_plan(
        plan, root=root, run_dir=run_dir, run_id=run_id, check=args.check,
        committed_baselines=committed,
        executor=None if args.executor == "auto" else args.executor)

    for row in report.regressions:
        if row["status"] == "ok":
            print(f"# guard ok {row['artifact']} [{row['topology']}] "
                  f"{row['row']} {row['field']}: {row['fresh']:.2f} "
                  f"(baseline {row['baseline']:.2f})")
        else:
            desc = row.get("detail") or (
                f"{row['fresh']:.2f} < baseline {row['baseline']:.2f} / "
                f"{report.tolerance}" if "fresh" in row else "")
            loc = " ".join(p for p in (row.get("row"), row.get("field"))
                           if p)
            print(f"REGRESSION {row['artifact']} [{row['topology']}] "
                  f"{loc} {row['status']}: {desc}", file=sys.stderr)
    c = report.counters
    print(f"# harness {report.run_id}: {c['completed']} completed, "
          f"{c['failed']} failed, {c['emitted']} emitted, "
          f"{c['retries']} retries, "
          f"{c['regression_failures']} regression failures")
    print(f"# report: {run_dir / 'harness_report.json'}")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
