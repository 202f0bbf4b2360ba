"""End-to-end training launcher of the port, on one device.

The reference's launcher (``repro/launch/train.py``) with the same presets,
config cut and command line, plus ``--device`` (default ``cuda``; pass
``cpu`` to run on the CPU). Features exercised: the deterministic data
pipeline, mixed precision (f32 masters, the compute dtype per call),
AdamW, checkpoint / auto-resume in the reference's file format, the
straggler monitor. There is no mesh: ``--model-parallel`` other than 1
raises. On the card the step replays a captured CUDA graph that updates
the params and the optimizer state in place (``train.loop.TrainStep``, the
counterpart of the reference's jit with the two donated): a restored
checkpoint is the trees its first call adopts, and a checkpoint is read
from them once the card is synchronised. The straggler monitor times the
host's time per call, as the reference's times its asynchronous dispatch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --preset tiny --steps 200 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, MarkovLM, SyntheticLM
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import StragglerMonitor, TrainConfig, make_train_step
from repro_torch.train.optimizer import AdamWConfig

PRESETS = {
    # name: (d_model, layers, heads, d_ff, vocab) — ~param count targets
    "tiny": (128, 4, 4, 512, 512),        # ~1M: CI / smoke
    "small": (256, 6, 8, 1024, 2048),     # ~8M: CPU example
    "100m": (768, 12, 12, 3072, 32000),   # ~124M: the assignment's e2e size
}


def preset_config(arch: str, preset: str):
    """The reference's cut: ``full`` is the published config, ``tiny`` the
    reduced one resized, the others the published one resized."""
    cfg = reduced_config(arch) if preset == "tiny" else get_config(arch)
    if preset in PRESETS:
        d, l, h, f, v = PRESETS[preset]
        kvh = min(cfg.num_kv_heads, h) or h
        if h % max(kvh, 1):
            kvh = h
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}-{preset}", num_layers=l, d_model=d,
            num_heads=h if cfg.num_heads else 0,
            num_kv_heads=kvh if cfg.num_heads else 0,
            head_dim=(d // h) if cfg.num_heads else 0,
            d_ff=0 if cfg.d_ff == 0 else f, vocab_size=v,
            num_experts=min(cfg.num_experts, 4),
            num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
            ssm_state_size=min(cfg.ssm_state_size, 32),
            ssm_head_dim=32 if cfg.ssm_state_size else cfg.ssm_head_dim,
            encoder_seq=64 if cfg.is_encoder_decoder else 0,
            encoder_layers=2 if cfg.is_encoder_decoder else 0,
            num_patches=16 if cfg.num_patches else 0,
            sliding_window=256 if cfg.sliding_window else None,
            compute_dtype="float32",
        )
    return cfg


def device_batch(batch: dict, device) -> dict:
    """A pipeline batch (int32 numpy) as long tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.long)
            for k, v in batch.items()}


def _synchronize(device) -> None:
    """Wait for the card's work: the step's last replay writes the trees a
    checkpoint reads."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS) + ["full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="markov", choices=("markov", "uniform"))
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--grad-compression", default=None, choices=(None, "bf16"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise ValueError("--model-parallel must be 1: the port trains on one "
                         "device (multi-device is ROADMAP.md Queue 1 item 9)")

    cfg = preset_config(args.arch, args.preset)
    model = build(cfg, device=args.device)
    dev = model.device
    print(f"arch={cfg.name} params≈{cfg.num_params()/1e6:.1f}M "
          f"device={dev} compute={cfg.compute_dtype}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    data = MarkovLM(data_cfg) if args.data == "markov" else SyntheticLM(data_cfg)

    train_cfg = TrainConfig(
        optim=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        remat=True)
    step_fn = make_train_step(model, train_cfg)

    params = model.init(0)
    opt_state = opt.init_state(params)
    start_step = 0
    if args.ckpt_dir:
        latest = ckpt.latest_valid_step(args.ckpt_dir)
        if latest is not None:
            state, start_step = ckpt.restore(
                args.ckpt_dir, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"resumed from checkpoint step {start_step}")

    monitor = StragglerMonitor()
    history = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = device_batch(data.batch_at(step), dev)
        monitor.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step + 1, **m})
            print(f"step {step+1:5d} loss={m['loss']:.4f} "
                  f"acc={m['accuracy']:.3f} gnorm={m['grad_norm']:.2f} "
                  f"lr={m['lr']:.2e}")
        slow = monitor.stop(step)
        if slow:
            print(f"  [straggler-monitor] step {step} exceeded EWMA "
                  f"threshold")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _synchronize(dev)
            ckpt.save(args.ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state})
            ckpt.cleanup(args.ckpt_dir, keep_last=3)

    dt = time.time() - t_start
    steps_done = args.steps - start_step
    if args.ckpt_dir and steps_done:
        _synchronize(dev)
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": params, "opt": opt_state})
    print(f"done: {steps_done} steps in {dt:.1f}s "
          f"({dt/max(steps_done,1)*1000:.0f} ms/step); "
          f"straggler flags: {len(monitor.flagged)}")
    if args.metrics_out and history:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"loss: {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
