"""Peak memory and step time of one family's training at published widths
and a given depth on one GPU: chip smoke phase 11's job alone
(``chip_smoke.train_family``), for choosing the depth cut of a config whose
every layer does not fit the card.

    python3 tools/train_depth_peaks.py ARCH:LAYERS [ARCH:LAYERS ...]

e.g. ``qwen3-4b:4 qwen3-4b:8 paligemma-3b:10``. Builds the kernels training
launches (K1, K5, K7) first. Each pair runs the job's 4 steps at 2 x 512
tokens (the warm-up, the capture and its replay, two more replays) with
its checks, in this one process, one pair after another. Prints one JSON
line a pair (layers, step ms by CUDA events, tokens/s, peak GB allocated,
params and state GB, the graph pool's GB, the job's seconds, or the error)
and the card's name and power limit.
"""
from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
TAG = "train depth peaks: "
KEYS = ("arch", "layers", "step_ms", "tokens_per_s", "peak_gb", "state_gb",
        "pool_gb", "job_s")


def main(argv) -> int:
    pairs = [(a, int(n)) for a, _, n in (x.partition(":") for x in argv)]
    if not pairs:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.kernels import build, counted_wrappers
    build.build_all(["gemm_packed_fused_a", "pack", "gemm_tiled"])
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = cs.Counters(counted_wrappers())
    card = cs.card_line()
    rc = 0
    for arch, layers in pairs:
        try:
            r = cs.train_family(torch, counters, arch, card, depth=layers)
            row = {k: r[k] for k in KEYS}
        except Exception as exc:  # noqa: BLE001 — reported, next pair runs
            row, rc = dict(arch=arch, layers=layers, error=str(exc)[:2000]), 1
        print(TAG + json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(TAG + json.dumps({"card": card}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
