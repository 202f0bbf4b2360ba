"""Where ``chip_smoke.py``'s phase 1 spends its time, on one GPU.

    python3 tools/smoke_phase_times.py

Runs the smoke's phase 1 (the build, the SASS checks, every kernel against
its plain version) with each module-level function of ``chip_smoke``
timed, and stops where phase 2 would start. Prints the card's name and
power limit, phase 1's seconds, then each function's cumulative seconds
and calls, the largest first. A function's seconds include those of the
functions it calls. Kernels already built under ``build/kernels`` are
reused (a library is named by a hash of its sources).
"""
from __future__ import annotations

import collections
import functools
import inspect
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SECONDS = collections.defaultdict(float)
CALLS = collections.Counter()


class _PhaseOneDone(Exception):
    pass


def _timed(name, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            SECONDS[name] += time.perf_counter() - t0
            CALLS[name] += 1
    return inner


def _stop(*args, **kwargs):
    raise _PhaseOneDone


def main() -> int:
    # Calls inside the module look its functions up at call time, so
    # rebinding them times every call.
    for name, fn in list(vars(chip_smoke).items()):
        if (inspect.isfunction(fn) and fn.__module__ == "chip_smoke"
                and name not in ("main", "log", "at_phase")):
            setattr(chip_smoke, name, _timed(name, fn))
    chip_smoke.phase_serve = _stop
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    try:
        chip_smoke.main([])
    except _PhaseOneDone:
        pass
    print(f"phase 1: {time.perf_counter() - t0:.1f} s")
    for name, s in sorted(SECONDS.items(), key=lambda kv: -kv[1])[:40]:
        print(f"{s:8.1f} s {CALLS[name]:6d} calls  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
