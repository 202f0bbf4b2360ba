"""Serving example of the PyTorch/CUDA port: the engine, batched or as a
request stream, on the card.

  PYTHONPATH=src python3 examples/torch_serve_lm.py --arch olmo-1b --batch 4 --new 24
  PYTHONPATH=src python3 examples/torch_serve_lm.py --stream --batch 12
  PYTHONPATH=src python3 examples/torch_serve_lm.py --stream --continuous --batch 12
  PYTHONPATH=src python3 examples/torch_serve_lm.py --device cpu

Trains nothing: it serves random weights from a seed on ``reduced_config``
of the arch, through ``repro_torch.serve``. By default one static batch is
decoded greedily (``Engine.generate``; on the card prefill and decode are
captured CUDA graphs). ``--stream`` offers the same number of requests as
a Poisson arrival stream to the batch-1 front end (``StreamFrontend``:
bounded admission queue, deadlines, retries, per-request fault
isolation); ``--continuous`` serves the stream through the
continuous-batching scheduler instead (``ContinuousScheduler``: one
batched decode step over a paged KV pool). ``--pack-weights`` packs every
dense weight tile-major at load (K5), so every step runs the fused-A
kernel K1 (and K2 for an MoE arch); ``--quantize`` packs int8 / int4 tiles.
Every mode ends with ``Engine.serve_report()`` and
``Engine.health_report()``; on the card a health report that is not empty
(a contraction that degraded) exits 1.
"""
import argparse
import json
import sys
import time

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.models import build
from repro_torch.models.model_registry import cli_device
from repro_torch.serve import (ContinuousConfig, ContinuousScheduler, Engine,
                               Request, ServeConfig, StreamConfig,
                               StreamFrontend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--pack-weights", action="store_true",
                    help="pack every dense weight tile-major at load time "
                         "(the fused pack-free-A GEMM on every step)")
    ap.add_argument("--quantize", default=None,
                    choices=("int8", "int8:col", "int4", "int4:col"),
                    help="quantize the packed weights at load (int8 or "
                         "nibble-packed int4 tiles; ':col' scales per column "
                         "at store; implies --pack-weights)")
    ap.add_argument("--stream", action="store_true",
                    help="serve a Poisson request stream through the "
                         "resilient front end instead of one static batch")
    ap.add_argument("--continuous", action="store_true",
                    help="with --stream: serve through the continuous-"
                         "batching scheduler (shared batched decode over a "
                         "paged KV pool) instead of the batch-1 front end")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = cli_device(args.device, "torch_serve_lm")

    cfg = reduced_config(args.arch)
    model = build(cfg, device=dev)
    params = model.init(0)
    engine = Engine(model, params, ServeConfig(
        max_len=args.prompt_len + args.new + 8,
        temperature=args.temperature,
        pack_weights=args.pack_weights or args.quantize is not None,
        quantize=args.quantize), device=dev)

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(args.batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)

    if args.stream:
        if cfg.family in ("vlm", "audio"):
            raise SystemExit("--stream serves token-LM requests only")
        rng_s = np.random.default_rng(1)
        reqs = [Request(request_id=i,
                        tokens=rng_s.integers(
                            0, cfg.vocab_size,
                            int(rng_s.choice((4, args.prompt_len))))
                        .astype(np.int32),
                        max_new_tokens=args.new, deadline_s=30.0)
                for i in range(args.batch)]
        schedule = [(float(t), r) for t, r in
                    zip(np.cumsum(rng_s.exponential(0.05, len(reqs))), reqs)]
        if args.continuous:
            block = next(b for b in (16, 8, 4, 2, 1)
                         if engine.cfg.max_len % b == 0)
            server = ContinuousScheduler(engine, ContinuousConfig(
                queue_capacity=max(2, args.batch // 2), max_live=4,
                block_size=block))
        else:
            server = StreamFrontend(engine, StreamConfig(
                queue_capacity=max(2, args.batch // 2), max_live=4))
        t0 = time.time()
        results = server.run(schedule)
        dt = time.time() - t0
        toks = sum(len(r.tokens) for r in results.values() if r.ok)
        mode = "continuous" if args.continuous else "batch-1"
        print(f"arch={cfg.name} stream={len(reqs)} reqs ({mode}) "
              f"new<={args.new}: {toks} tokens in {dt:.2f}s")
        for rid in sorted(results):
            r = results[rid]
            print(f"  req{rid}: {r.status:13s} lat={r.latency_s:6.2f}s "
                  f"{r.tokens.tolist() if len(r.tokens) else r.detail}")
        print("lifecycle counters:", server.stats())
    else:
        t0 = time.time()
        out = engine.generate(batch, max_new_tokens=args.new)
        dt = time.time() - t0
        print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
              f"new={args.new}")
        print(f"generated {tuple(out.shape)} in {dt:.2f}s "
              f"({args.batch * args.new / dt:.1f} tok/s incl. kernel loads "
              f"and graph captures)")
        for i, row in enumerate(out):
            print(f"  req{i}: {row.tolist()}")
    # The registries a deployment would scrape: the request-lifecycle
    # report and the dispatch-health degradation report.
    print("serve_report:", json.dumps(engine.serve_report(), indent=2,
                                      default=str))
    health = engine.health_report()
    print("health_report:", json.dumps(health, indent=2, default=str)
          if health else "{} (healthy: no degraded lowerings)")
    return 1 if health and dev.type == "cuda" else 0


if __name__ == "__main__":
    sys.exit(main())
