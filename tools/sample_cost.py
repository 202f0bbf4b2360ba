"""What a sampled decode step costs beside a greedy one on one GPU: this
tree's ``repro_torch`` against another checkout's, in turns.

    python3 tools/sample_cost.py OTHER_TREE [ROUNDS]

OTHER_TREE is a checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into a gitignored directory). Each run is a
fresh process that imports ``repro_torch`` from one tree and loads the
kernels from this tree's ``build/kernels`` (a kernel's library is named by
a hash of its sources). A run serves full-width olmo-1b (packed bf16
weights, max_len 256, bf16 cache) through ``Engine.generate`` at
``chip_smoke.py``'s phase 2 prompt (4 x 128) and steps (32): two warm
calls greedy and two sampled (temperature 0.7), so that every graph of
either tree has been captured, then 3 rounds, greedy and sampled in
turns, of a 32-step and a 1-step call each (host clock, synchronised).
A decode step is (32 steps - 1 step) / 31 of the means, as the smoke
takes it. The runs take turns (other, this, this, other) for ROUNDS
rounds (default 2). It prints each run, then each tree's quartiles of
the sampled step's ms, the greedy step's and their difference, with the
card's name and power limit, as one JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "sample cost: "
TEMPERATURE = 0.7


def one_run(src: str) -> None:
    """One side, in its own process: ``repro_torch`` from ``src``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch import configs, models, serve
    from repro_torch.kernels import build
    build.BUILD_DIR = ROOT / "build" / "kernels"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    cfg = dataclasses.replace(configs.get_config("olmo-1b"),
                              compute_dtype="bfloat16")
    model = models.build(cfg, device="cuda")
    greedy = serve.ServeConfig(max_len=smoke.MAX_LEN, pack_weights=True,
                               cache_dtype="bfloat16")
    sampled = dataclasses.replace(greedy, temperature=TEMPERATURE, seed=11)
    engine = serve.Engine(model, smoke.bf16_tree(torch, model.init(0)),
                          greedy, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, smoke.PROMPT,
                                     generator=gen)}
    steps = smoke.STEPS

    def call(mode, n_new):
        engine.cfg = sampled if mode == "sampled" else greedy
        t0 = time.perf_counter()
        engine.generate(batch, max_new_tokens=n_new)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    for mode in ("greedy", "sampled"):
        for _ in range(2):
            call(mode, steps)
    times = {m: ([], []) for m in ("greedy", "sampled")}
    for rnd in range(3):
        order = ("greedy", "sampled") if rnd % 2 == 0 else ("sampled", "greedy")
        for mode in order:
            times[mode][0].append(call(mode, steps))
            times[mode][1].append(call(mode, 1))
    ms = {m: (sum(a) / len(a) - sum(b) / len(b)) / (steps - 1)
          for m, (a, b) in times.items()}
    print(TAG + json.dumps(dict(src=src, greedy_ms_per_step=ms["greedy"],
                                sampled_ms_per_step=ms["sampled"],
                                difference_ms=ms["sampled"] - ms["greedy"])),
          flush=True)


def quartiles(values) -> tuple:
    """(first quartile, median, third quartile), linear interpolation."""
    v = sorted(values)

    def at(q):
        pos = q * (len(v) - 1)
        lo = int(pos)
        return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (pos - lo)
    return at(0.25), at(0.5), at(0.75)


def main(argv) -> int:
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    rounds = int(argv[1]) if len(argv) == 2 else 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build_all(["gemm_packed_fused_a", "pack"])
    rows = []
    for tag, tree in [("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)] * rounds:
        run = subprocess.run(
            [sys.executable, __file__, "--one", str(tree / "src")],
            capture_output=True, text=True, timeout=600)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith(TAG)]
        if run.returncode != 0 or len(line) != 1:
            print(run.stdout[-2000:] + run.stderr[-4000:], file=sys.stderr)
            return 1
        rows.append(dict(json.loads(line[0][len(TAG):]), tree=tag))
        print(f"{tag}: {rows[-1]}", flush=True)
    summary = {}
    for key in ("sampled_ms_per_step", "greedy_ms_per_step", "difference_ms"):
        summary[key] = {t: dict(zip(("q1", "median", "q3"), quartiles(
            [r[key] for r in rows if r["tree"] == t])))
            for t in ("other", "this")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"sample_cost": summary, "other": str(other),
                      "card": card.strip()}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one_run(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
