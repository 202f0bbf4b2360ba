"""What the prefill's graphs cost the continuous scheduler on one GPU:
this tree's ``repro_torch`` against another checkout's, in turns.

    python3 tools/prefill_graph_cost.py OTHER_TREE [ROUNDS]

OTHER_TREE is a checkout of the repo (for example the parent commit,
unpacked by ``git archive`` into a gitignored directory). Each run is a
fresh process that imports ``repro_torch`` from one tree and loads the
kernels from this tree's ``build/kernels`` (a kernel's library is named by
a hash of its sources). A run serves full-width olmo-1b (packed bf16
weights, max_len 256, bf16 cache) through ``ContinuousScheduler`` as
``chip_smoke.py``'s phase 2b run (i) does: its 24 requests, max_live 8,
block size 16. First a warming run of 8 requests whose prompt lengths lie
outside run (i)'s 16-128, so that no length of run (i) has been seen; then
run (i) three times on fresh schedulers over the same engine. Where the
engine graphs its prefill, the first pass's prefills are each length's
warm-up, the second's its capture, the third's replays; an engine without
prefill graphs runs all three eagerly. Each pass reports its host ms per
batched step (wall clock over the batched steps, the prefills included)
and tokens/s. The runs take turns (other, this, this, other) for ROUNDS
rounds (default 2). It prints each run, then for each pass each tree's
quartiles of ms per step and the pairs in which this tree was faster,
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
TAG = "prefill graph cost: "
PASSES = ("first", "second", "third")


def one_run(src: str) -> None:
    """One side, in its own process: ``repro_torch`` from ``src``."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch import configs, models, serve
    from repro_torch.kernels import build
    build.BUILD_DIR = ROOT / "build" / "kernels"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    cfg = dataclasses.replace(configs.get_config("olmo-1b"),
                              compute_dtype="bfloat16")
    model = models.build(cfg, device="cuda")
    engine = serve.Engine(model, smoke.bf16_tree(torch, model.init(0)),
                          serve.ServeConfig(max_len=smoke.MAX_LEN,
                                            pack_weights=True,
                                            cache_dtype="bfloat16"),
                          device="cuda")
    r = np.random.default_rng(99)
    warm = [serve.Request(request_id=i, tokens=r.integers(
        0, cfg.vocab_size, int(n)), max_new_tokens=8)
        for i, n in enumerate((4, 8, 12, 15, 130, 140, 150, 160))]
    reqs = smoke.continuous_requests(serve, cfg.vocab_size)

    def run(requests):
        cs = serve.ContinuousScheduler(engine, serve.ContinuousConfig(
            queue_capacity=len(requests), max_live=smoke.CONT_LIVE,
            block_size=smoke.CONT_BLOCK, max_retries=1))
        step, steps = cs._step, [0]

        def counted(*args):
            steps[0] += 1
            return step(*args)
        cs._step = counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in requests:
            cs.submit(q)
        cs.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = sum(len(res.tokens) for res in cs.results.values())
        del cs._step
        return dict(ms_per_step=wall * 1e3 / steps[0], tokens_per_s=n / wall,
                    steps=steps[0], tokens=n)
    run(warm)
    out = {name: run(reqs) for name in PASSES}
    graphs = getattr(engine, "_prefill_graphs", {})
    print(TAG + json.dumps(dict(
        src=src, passes=out, prefill_graphs=len(graphs),
        prefill_graph_replays=sum(g.replays for g in graphs.values()))),
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
    for name in PASSES:
        by = {t: [r["passes"][name]["ms_per_step"] for r in rows
                  if r["tree"] == t] for t in ("other", "this")}
        pairs = list(zip(by["other"], by["this"]))
        summary[name] = dict(
            {t: dict(zip(("q1", "median", "q3"), quartiles(v)))
             for t, v in by.items()},
            pairs=len(pairs), this_faster=sum(b < a for a, b in pairs))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"prefill_graph_cost": summary, "other": str(other),
                      "card": card.strip()}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        one_run(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
