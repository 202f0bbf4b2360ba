"""Host cost of the port's guarded dispatch on one GPU: this tree's
``repro_torch`` against another checkout's, in turns.

    python3 tools/guard_cost.py OTHER_TREE [ROUNDS]

OTHER_TREE is a checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into a gitignored directory). Each run is a
fresh process that imports ``repro_torch`` from one tree and loads the
kernels from this tree's ``build/kernels`` (a kernel's library is named by
a hash of its sources, so a tree whose sources differ builds its own
there). A run measures, on full-width olmo-1b with packed bf16 weights and
a 4 x 128 prompt, the decode ms/step of ``Engine.generate`` by the host
clock ((32 steps - 1 step) / 31, each the mean of 3 warm calls), and the
host us of one packed ``gemm.linear`` at M 4 ([2048, 2048], 2000 calls,
synchronised once). The runs take turns (other, this, this, other) for
ROUNDS rounds (default 5: ten pairs). It prints each run, then for each
metric each tree's quartiles and the pairs in which this tree was faster,
with the card's name and power limit, as one JSON line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "guard cost: "
STEPS, PROMPT, MAX_LEN = 32, (4, 128), 256


def one_run(src: str) -> None:
    """One side, in its own process: ``repro_torch`` from ``src``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch import configs, models, serve
    from repro_torch.core import gemm, layered
    from repro_torch.kernels import build
    build.BUILD_DIR = ROOT / "build" / "kernels"
    cfg = dataclasses.replace(configs.get_config("olmo-1b"),
                              compute_dtype="bfloat16")
    model = models.build(cfg, device="cuda")
    engine = serve.Engine(model, _bf16(torch, model.init(0)),
                          serve.ServeConfig(max_len=MAX_LEN,
                                            pack_weights=True,
                                            cache_dtype="bfloat16"),
                          device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, PROMPT,
                           generator=torch.Generator().manual_seed(1))

    def gen_s(steps):
        t0 = time.perf_counter()
        engine.generate({"tokens": prompt}, max_new_tokens=steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    gen_s(2)
    t32 = sum(gen_s(STEPS) for _ in range(3)) / 3
    t1 = sum(gen_s(1) for _ in range(3)) / 3
    pw = layered.PackedWeight.pack(torch.randn(2048, 2048, device="cuda",
                                               dtype=torch.bfloat16))
    x = torch.randn(4, 2048, device="cuda", dtype=torch.bfloat16)
    for _ in range(50):
        gemm.linear(x, pw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        gemm.linear(x, pw)
    torch.cuda.synchronize()
    print(TAG + json.dumps(dict(
        src=src, decode_ms_per_step=(t32 - t1) / (STEPS - 1) * 1e3,
        linear_us=(time.perf_counter() - t0) / 2000 * 1e6)), flush=True)


def _bf16(torch, tree):
    """Every floating leaf of a parameter tree as bf16 (the compute dtype)."""
    if isinstance(tree, dict):
        return {k: _bf16(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(torch, v) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(torch.bfloat16)
    return tree


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
    rounds = int(argv[1]) if len(argv) == 2 else 5
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
    for key in ("decode_ms_per_step", "linear_us"):
        by = {t: [r[key] for r in rows if r["tree"] == t]
              for t in ("other", "this")}
        pairs = list(zip(by["other"], by["this"]))
        summary[key] = dict(
            {t: dict(zip(("q1", "median", "q3"), quartiles(v)))
             for t, v in by.items()},
            pairs=len(pairs), this_faster=sum(b < a for a, b in pairs))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"guard_cost": summary, "other": str(other),
                      "card": card.strip()}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one_run(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
