"""The paper's experiment on the PyTorch/CUDA port: every lowering strategy
over square GEMM sizes, on the card.

  PYTHONPATH=src python3 examples/torch_gemm_strategies.py [--sizes 256,1024,4096]
  PYTHONPATH=src python3 examples/torch_gemm_strategies.py --device cpu --sizes 16,32

Prints a table in the manner of the paper's Figs. 4-9: ms per strategy,
speedup over the PLuTo proxy, and which strategy wins at each size. Each
size is one declared ContractionSpec; every timed column is that spec run
under an explicit strategy name, and ``auto`` is what the registry would
dispatch to for operands on this device. On the card each call is timed
with CUDA events (the median of ``--reps`` after one warm call), on the
CPU with the host clock. The rank-1 loop (naive) and PLuTo's proxy run up
to 512, the single-block ``intrinsic`` up to 2048. After each row, the
largest error of any strategy against the f32 product beside its gate
(1e-4 of the largest |output|, TF32 off), as ``max|err| = E (gate G)``;
the exit code is 1 if any is over it.
"""
import argparse
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.core import STRATEGIES, ContractionSpec, contract, dispatch
from repro_torch.kernels import ref
from repro_torch.models.model_registry import cli_device

REL_GATE = 1e-4
# The largest size each slow comparison strategy runs at.
MAX_SIZE = {"naive": 512, "pluto": 512, "intrinsic": 2048}


def time_ms(fn, dev: torch.device, reps: int) -> tuple:
    """(median ms of ``reps`` calls after one warm call, the last output):
    CUDA events on the card, the host clock on the CPU."""
    out = fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="64,256,512")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = cli_device(args.device, "torch_gemm_strategies")
    sizes = [int(s) for s in args.sizes.split(",")]
    rng = np.random.default_rng(0)

    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}"
          f", float32, ms (speedup over pluto)")
    hdr = f"{'n':>6s} | " + " | ".join(f"{s:>20s}" for s in STRATEGIES)
    print(hdr)
    print("-" * len(hdr))
    ok = True
    for n in sizes:
        a, b = (torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
                .to(dev) for _ in range(2))
        want = ref.matmul_ref(a, b)
        spec = ContractionSpec.dense(n, n, n, "float32", accum="f32")
        times, err = {}, 0.0
        for s in STRATEGIES:
            if n > MAX_SIZE.get(s, n):
                times[s] = float("nan")
                continue
            times[s], out = time_ms(
                lambda s=s: contract(spec, a, b, strategy=s), dev, args.reps)
            # a NaN counts as an infinite error, never as none
            err = max(err, float((out - want).abs().nan_to_num(
                nan=float("inf")).max()))
        base = times["pluto"]
        cells = []
        for s in STRATEGIES:
            t = times[s]
            if np.isnan(t):
                cells.append(f"{'--':>20s}")
            else:
                spd = f" ({base / t:5.1f}x)" if not np.isnan(base) else ""
                cells.append(f"{t:10.3f}ms{spd:>8s}")
        best = min((t, s) for s, t in times.items() if not np.isnan(t))[1]
        auto = dispatch(spec, on_card=dev.type == "cuda").name
        print(f"{n:6d} | " + " | ".join(cells)
              + f"   best={best}  auto={auto}")
        gate = REL_GATE * max(float(want.abs().max()), 1.0)
        print(f"{'':6s}   every strategy at n={n}: max|err| = {err:.2e} "
              f"(gate {gate:.2e})")
        ok &= err <= gate
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
