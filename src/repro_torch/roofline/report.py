"""Tables of the port's dry run (``results/dryrun_torch``), the counterpart
of ``repro/roofline/report.py``. The numbers are a model over fake tensors
(``launch/dryrun.py``), divided by the H100 SXM's data-sheet figures
(``roofline/hw.py``), not measurements.

  PYTHONPATH=src python -m repro_torch.roofline.report [RESULTS_DIR]
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")


def load(results_dir: str = RESULTS, tag: Optional[str] = None) -> List[dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(f) as fh:
            d = json.load(fh)
        if (d.get("tag") or "") != (tag or ""):
            continue
        rows.append(d)
    return rows


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    return f"{n/2**30:.2f}"


def dryrun_table(rows: List[dict]) -> str:
    out = ["| arch | shape | mesh | chips | status | run s | args GiB | "
           "peak GiB | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d["status"] != "ok":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | - | "
                       f"FAILED: {d.get('op') or d.get('error', '')[:60]} "
                       f"| | | | |")
            continue
        m = d["memory"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['chips']} | ok "
            f"| {d.get('run_s', 0):.0f} | {_fmt_bytes(m['argument_bytes'])} "
            f"| {_fmt_bytes(m['peak_per_device'])} "
            f"| {'yes' if d.get('fits_hbm') else 'NO'} |")
    return "\n".join(out)


def roofline_table(rows: List[dict], mesh: str = "single") -> str:
    out = ["| arch | shape | compute s | memory s | collective s (NVLink "
           "GB / all GB) | bottleneck | MODEL_FLOPS | useful ratio "
           "| roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d["status"] != "ok" or d["mesh"] != mesh:
            continue
        r = d["roofline"]
        out.append(
            f"| {d['arch']} | {d['shape']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"({r['collective_bytes_nvlink']/1e9:.2f} / "
            f"{r['collective_bytes_per_device']/1e9:.2f}) "
            f"| **{r['bottleneck']}** | {r['model_flops']:.3e} "
            f"| {r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def bottleneck_summary(rows: List[dict], mesh: str = "single") -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for d in rows:
        if d["status"] == "ok" and d["mesh"] == mesh:
            b = d["roofline"]["bottleneck"]
            counts[b] = counts.get(b, 0) + 1
    return counts


def worst_cells(rows: List[dict], mesh: str = "single", k: int = 5):
    ok = [d for d in rows if d["status"] == "ok" and d["mesh"] == mesh]
    by_frac = sorted(ok, key=lambda d: d["roofline"]["roofline_fraction"])
    by_coll = sorted(ok, key=lambda d: -d["roofline"]["collective_s"])
    return by_frac[:k], by_coll[:k]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rows = load(argv[0] if argv else RESULTS)
    print(dryrun_table(rows))
    for mesh in ("single", "multi"):
        print()
        print(roofline_table(rows, mesh))
        print()
        print(f"bottlenecks ({mesh}):", bottleneck_summary(rows, mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
