"""End-to-end training launcher of the port.

The reference's launcher (``repro/launch/train.py``) with the same presets,
config cut and command line, plus ``--device`` (default ``cuda``; pass
``cpu`` to run on the CPU). Features exercised: the deterministic data
pipeline, mixed precision (f32 masters, the compute dtype per call),
AdamW, checkpoint / auto-resume in the reference's file format (elastic:
mesh-agnostic), the straggler monitor.

The mesh is ``(world // model_parallel, model_parallel)`` over the
``torch.distributed`` world (``launch.mesh.make_host_mesh``): started by
``torchrun`` (or with ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` set), the launcher joins the group (NCCL on the card, gloo
on the CPU; a failed init raises); otherwise the world is this process.
Over more than one rank the params and the AdamW state are placed as
DTensors by ``parallel.sharding.named_shardings``, each rank builds the
same global batch and keeps its rows, and the step is the functional one
with every contraction on its plain torch lowering (DTensor operands).
On a mesh whose every axis is 1 the sharding is the identity and the
tensors stay plain. On the card the step then replays a captured CUDA
graph that updates the params and the optimizer state in place
(``train.loop.TrainStep``, the counterpart of the reference's jit with the
two donated): a restored checkpoint is the trees its first call adopts,
and a checkpoint is read from them once the card is synchronised. The
straggler monitor times the host's time per call, as the reference's
times its asynchronous dispatch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --preset tiny --steps 200 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \\
      --model-parallel 2 --device cpu --preset tiny --steps 20
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, MarkovLM, SyntheticLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build
from repro_torch.parallel import sharding as shard_rules
from repro_torch.parallel.mesh import mesh_size, replicated, use_mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import (StragglerMonitor, TrainConfig,
                                     _eager_step, make_train_step)
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


def join_world(device: str) -> None:
    """Join the ``torch.distributed`` group the environment describes
    (``WORLD_SIZE`` set, as ``torchrun`` sets it): NCCL for the card, gloo
    for the CPU, each rank on its local card. Without it, nothing."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def device_of(device: str) -> str:
    """The rank's device: its local card under a process group."""
    if torch.device(device).type == "cuda" and dist.is_initialized():
        return f"cuda:{torch.cuda.current_device()}"
    return device


def _synchronize(device) -> None:
    """Wait for the card's work: the step's last replay writes the trees a
    checkpoint reads."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _replication(sharded: bool):
    """Under a sharded step, plain tensors made inside the model (RoPE
    tables, masks, positions) meet DTensor parameters as replicated
    values."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


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
    join_world(args.device)
    mesh = make_host_mesh(args.model_parallel)
    sharded = mesh_size(mesh) > 1
    rank = dist.get_rank() if dist.is_initialized() else 0

    cfg = preset_config(args.arch, args.preset)
    model = build(cfg, device=device_of(args.device))
    dev = model.device
    world = dist.get_world_size() if dist.is_initialized() else 1
    print(f"arch={cfg.name} params≈{cfg.num_params()/1e6:.1f}M "
          f"device={dev} compute={cfg.compute_dtype} "
          f"mesh={tuple(mesh.shape)} world={world}")

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    data = MarkovLM(data_cfg) if args.data == "markov" else SyntheticLM(data_cfg)

    train_cfg = TrainConfig(
        optim=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
        remat=True)
    params = model.init(0)
    opt_state = opt.init_state(params)
    shardings = None
    if sharded:
        p_sh = shard_rules.named_shardings(cfg, params, mesh)
        shardings = {"params": p_sh,
                     "opt": {"mu": p_sh, "nu": p_sh, "step": replicated(mesh)}}
        params = shard_rules.place(params, shard_rules.param_specs(
            cfg, params, mesh), mesh)
        opt_state = opt.init_state(params)
        step_fn = _eager_step(model, train_cfg)
    else:
        step_fn = make_train_step(model, train_cfg)
    start_step = 0
    if args.ckpt_dir:
        latest = ckpt.latest_valid_step(args.ckpt_dir)
        if latest is not None:
            state, start_step = ckpt.restore(
                args.ckpt_dir, {"params": params, "opt": opt_state},
                shardings=shardings)
            params, opt_state = state["params"], state["opt"]
            print(f"resumed from checkpoint step {start_step}")

    monitor = StragglerMonitor()
    history = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = device_batch(data.batch_at(step), dev)
        if sharded:
            batch = shard_rules.place(
                batch, shard_rules.batch_specs(batch, mesh), mesh)
        monitor.start()
        with (use_mesh(mesh) if sharded else contextlib.nullcontext()), \
                _replication(sharded):
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
            if rank == 0:
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
    if args.metrics_out and history and rank == 0:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"loss: {first:.4f} -> {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
