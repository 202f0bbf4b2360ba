"""Per-topology regression baselines — the ONE place the guard rule lives.

The port of the JAX package's ``harness/baselines.py``: the same rule,
names and schema.

Committed ``BENCH_*.smoke.json`` artifacts are topology-keyed (schema 2):

    {"bench": "...", "unit_time": "us_per_call", "schema": 2,
     "topologies": {"cpu:1": {"results": [...]},
                    "cuda:16x16": {"results": [...]}}}

Legacy (schema-1) payloads — a bare ``{"results": [...]}`` — are read as
the ``cpu:1`` entry, the topology every one of them was measured on, so
pre-migration baselines stay comparable.

The checker compares a fresh run ONLY against the baseline entry whose
topology key matches the job that produced it: a committed multi-device
baseline can neither mask nor trigger a local-CPU regression, and a
topology the run executed WITHOUT a committed baseline entry fails loudly
(an unguarded bench must fail CI, not silently pass).
Speedup ratios — fields named ``speedup*`` — are what the guard compares
(ratios, not raw times, so machine speed never trips it).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Tuple

__all__ = ["REGRESSION_TOLERANCE", "SCHEMA_VERSION", "row_key",
           "speedup_fields", "key_str", "topology_payloads",
           "snapshot_baselines", "merge_topology_artifact",
           "check_artifact"]

REGRESSION_TOLERANCE = 1.25  # fail when fresh speedup < baseline / 1.25
SCHEMA_VERSION = 2

# The key legacy (schema-1) payloads are attributed to: they were all
# measured on the single-device CPU topology. A literal, not
# LOCAL_TOPOLOGY.key: the port's local topology is the card (cuda:1), and a
# committed schema-1 CPU payload must not read as a card baseline.
LEGACY_TOPOLOGY_KEY = "cpu:1"


def row_key(row: dict) -> tuple:
    """Every identity-ish field a bench row may carry: rows that differ
    only in size (e.g. per-n rows with no "name") must not collapse onto
    one key, or the guard compares every baseline row against a single
    arbitrary fresh row."""
    return (row.get("name"), row.get("dist"), row.get("shape"),
            row.get("dtype"), row.get("n"), row.get("e"), row.get("m"),
            row.get("k"))


def speedup_fields(row: dict) -> Dict[str, float]:
    return {k: v for k, v in row.items()
            if k.startswith("speedup") and isinstance(v, (int, float))}


def key_str(key) -> str:
    return "/".join(str(p) for p in key if p is not None) or "<row>"


def topology_payloads(payload: dict) -> Dict[str, dict]:
    """``{topology_key: {"results": [...]}}`` for either schema. A legacy
    payload (no "topologies") is one ``cpu:1`` entry."""
    if "topologies" in payload:
        return dict(payload["topologies"])
    return {LEGACY_TOPOLOGY_KEY: {"results": payload.get("results", [])}}


def snapshot_baselines(root) -> Dict[str, dict]:
    """Read every committed ``BENCH_*.smoke.json`` under ``root`` BEFORE a
    run overwrites them (unreadable files are skipped — a corrupt baseline
    then surfaces as missing, which fails loudly downstream)."""
    root = pathlib.Path(root)
    baselines: Dict[str, dict] = {}
    for path in sorted(root.glob("BENCH_*.smoke.json")):
        try:
            baselines[path.name] = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
    return baselines


def merge_topology_artifact(fresh: dict, topology_key: str,
                            committed: Optional[dict] = None) -> dict:
    """Rewrite a bench's fresh (legacy-format) artifact as a schema-2
    payload holding this run's results under ``topology_key`` while
    PRESERVING every other topology's entry from the committed baseline —
    so committing a locally regenerated smoke artifact never wipes the
    multi-device baselines it didn't re-measure."""
    topologies: Dict[str, dict] = {}
    if committed is not None:
        topologies.update(topology_payloads(committed))
    fresh_entries = topology_payloads(fresh)
    # A legacy fresh payload lands under LEGACY_TOPOLOGY_KEY; re-home it
    # to the topology of the job that actually produced it.
    entry = fresh_entries.get(topology_key,
                              fresh_entries.get(LEGACY_TOPOLOGY_KEY, {}))
    topologies[topology_key] = entry
    meta = {k: v for k, v in fresh.items()
            if k not in ("results", "topologies", "schema")}
    return {**meta, "schema": SCHEMA_VERSION, "topologies": topologies}


def check_artifact(artifact_name: str, topology_key: str,
                   fresh: Optional[dict], baseline: Optional[dict],
                   tolerance: float = REGRESSION_TOLERANCE
                   ) -> Tuple[int, List[dict]]:
    """Compare one artifact's fresh results against its committed baseline
    AT THE SAME TOPOLOGY. Returns ``(failures, checks)`` where ``checks``
    records every verdict (pass or fail) machine-readably.

    Failure modes: no committed baseline at all (``missing_baseline``), a
    committed baseline with no entry for the executed topology
    (``missing_topology``), the artifact vanishing after the run
    (``missing_artifact``), a baseline row with no fresh counterpart
    (``missing_row``), and a guarded speedup ratio regressing past
    ``tolerance``. Baseline entries for OTHER topologies are skipped.
    """
    failures = 0
    checks: List[dict] = []

    def _fail(status: str, **extra) -> None:
        nonlocal failures
        checks.append({"artifact": artifact_name, "topology": topology_key,
                       "status": status, **extra})
        failures += 1

    if baseline is None:
        _fail("missing_baseline",
              detail="smoke artifact has no committed baseline — commit it "
                     "so the guard covers this bench")
        return failures, checks
    base_entry = topology_payloads(baseline).get(topology_key)
    if base_entry is None:
        _fail("missing_topology",
              detail=f"committed baseline has no entry for topology "
                     f"{topology_key!r} (has "
                     f"{sorted(topology_payloads(baseline))})")
        return failures, checks
    if fresh is None:
        _fail("missing_artifact", detail="artifact missing after run")
        return failures, checks
    fresh_entry = topology_payloads(fresh).get(topology_key)
    if fresh_entry is None:
        _fail("missing_artifact",
              detail=f"fresh artifact has no entry for topology "
                     f"{topology_key!r}")
        return failures, checks

    fresh_rows = {row_key(r): r for r in fresh_entry.get("results", [])}
    for brow in base_entry.get("results", []):
        frow = fresh_rows.get(row_key(brow))
        if frow is None:
            _fail("missing_row", row=key_str(row_key(brow)))
            continue
        for field, bval in speedup_fields(brow).items():
            fval = frow.get(field)
            if not isinstance(fval, (int, float)):
                continue
            ok = fval >= bval / tolerance
            checks.append({"artifact": artifact_name,
                           "topology": topology_key,
                           "row": key_str(row_key(brow)), "field": field,
                           "fresh": fval, "baseline": bval,
                           "status": "ok" if ok else "regression"})
            if not ok:
                failures += 1
    return failures, checks
