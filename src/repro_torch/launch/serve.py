"""Serving launcher of the port: load a checkpoint (or random-init), serve
one batch of requests, report the throughput.

The reference's launcher (``repro/launch/serve.py``) with the same flags and
printed lines, plus ``--device`` (default ``cuda``; pass ``cpu`` to run on
the CPU). ``--preset`` is the training launcher's (``full`` is the
published config); ``--ckpt-dir`` restores ``{"params": ...}`` from a
checkpoint in the reference's file format, as ``launch.train`` writes it.
A VLM gets a batch of patch embeddings, an encoder-decoder one of audio
frame embeddings, drawn from the same seed as the prompts. After the
reference's lines it prints the dispatch-health report
(``core.health.health_report()``), then whether the decode step is a
replayed CUDA graph (the engine's default on the card, ``serve.graphs``;
the steady-state ms/decode-step is then the graph's) or eager; on the
card, where no contraction degrades (a failing kernel raises), a health
report that is not empty fails the run with exit code 1.

  PYTHONPATH=src python3 -m repro_torch.launch.serve --arch olmo-1b \\
      --requests 8 --prompt-len 16 --new 32 [--ckpt-dir /tmp/ckpt] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core import health
from repro_torch.launch.train import PRESETS, preset_config
from repro_torch.models import build
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import checkpoint as ckpt


def request_batch(cfg, requests: int, prompt_len: int, seed: int = 0) -> dict:
    """The launcher's batch, as numpy: ``tokens`` [B, S] int32 from the
    seed, then ``patches`` [B, P, d] (VLM) or ``frames`` [B, Se, d]
    (encoder-decoder) f32 from the same generator, as the reference draws
    them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (requests, prompt_len)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(requests, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(requests, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def run(argv=None) -> dict:
    """The launcher's work, printing the reference's lines and the health
    report: ``{"cfg", "tokens" [requests, new], "seconds", "tok_s",
    "ms_per_step"}`` of the timed ``generate``, the ``"health"`` report
    after it and whether the run was ``"on_card"``. :func:`main` is this
    with an exit code."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny",
                    choices=list(PRESETS) + ["full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = preset_config(args.arch, args.preset)
    model = build(cfg, device=args.device)
    params = model.init(0)
    if args.ckpt_dir:
        restored, step = ckpt.restore(args.ckpt_dir, {"params": params})
        params = restored["params"]
        print(f"loaded checkpoint step {step}")

    engine = Engine(model, params, ServeConfig(
        max_len=args.prompt_len + args.new + 8,
        temperature=args.temperature), device=args.device)
    batch = request_batch(cfg, args.requests, args.prompt_len)

    # warm (the first launches build the kernels), then measure steady-state
    # decode throughput; generate returns host tokens, so it has synchronised
    engine.generate(batch, max_new_tokens=2)
    t0 = time.time()
    out = engine.generate(batch, max_new_tokens=args.new)
    dt = time.time() - t0
    tok_s, ms_step = args.requests * args.new / dt, dt / args.new * 1e3
    print(f"arch={cfg.name} requests={args.requests} "
          f"prompt={args.prompt_len} new={args.new}")
    print(f"steady-state: {tok_s:.1f} tok/s ({ms_step:.1f} ms/decode-step)")
    print("first request:", out[0][:16].tolist())
    report = health.health_report()
    print("health:", json.dumps(report) if report else "no degradation")
    print("decode step:", "a captured CUDA graph, replayed"
          if engine._graphed else "eager")
    return {"cfg": cfg, "tokens": out, "seconds": dt, "tok_s": tok_s,
            "ms_per_step": ms_step, "graphed": engine._graphed,
            "health": report,
            "on_card": torch.device(args.device).type == "cuda"}


def main(argv=None) -> int:
    res = run(argv)
    return 1 if res["on_card"] and res["health"] else 0


if __name__ == "__main__":
    sys.exit(main())
