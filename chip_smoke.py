"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once, into ``build/kernels/``) and hold each kernel
     against its plain torch version on the card: gemm_packed_fused_a at
     the serving path's shapes in bf16, plus f32, int8 and int4 B with tile
     and col scales, both tile layouts, bias and every epilogue.
  2. Serve full-width olmo-1b (16 layers, d_model 2048, vocab 50304, bf16,
     random weights from a seed, made on the card) through
     ``Engine(..., ServeConfig(pack_weights=True))``: prompt batch 4 x 128,
     then 32 greedy decode steps. The kernel launch counts are set to 0
     just before ``Engine.generate`` and read just after; the first
     prefill's logits are compared with the same weights run through the
     plain version on the card.
  3. Timings: warm Engine.generate calls (decode ms/step and tokens/s end
     to end), the model's prefill and decode forwards alone, a profile of
     the decode forward, and for each kernel shape its time beside its
     bound, its plain version and torch.matmul.
The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON summary.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
H100_BF16_FLOPS = 989e12      # dense tensor-core peak, bf16 (data sheet)
H100_HBM_BYTES = 3.35e12      # HBM3 bytes/s

# (K, N) of every contraction of one olmo-1b forward, with its count: q, k,
# v, o (2048x2048), gate and up (2048x8192), down (8192x2048), LM head.
OLMO_SHAPES = {(2048, 2048): 4, (2048, 8192): 2, (8192, 2048): 1,
               (2048, 50304): None}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` calls (CUDA events)."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(m, k, n, a_item, b_bytes, out_item, peak_flops):
    """Least time for the call: max(operations / peak, bytes / HBM rate)
    with A, packed B (+ scales) read once and the output written once."""
    flops = 2.0 * m * k * n
    nbytes = m * k * a_item + b_bytes + m * n * out_item
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def close(got, want, rtol, atol):
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * want.float().abs()))
    return ok, float(err.max())


def phase_kernels(torch, gp, ref, tf):
    """Kernel vs plain version on the card; returns the per-shape table."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = []
    table = []

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def check(tag, a, bp, n, fmt, rtol, atol, scales=None, **kw):
        got = gp.gemm_packed_fused_a(a, bp, n, b_scales=scales, b_format=fmt,
                                     **kw)
        torch.cuda.synchronize()
        want = gp.gemm_packed_fused_a_plain(a, bp, n, b_scales=scales,
                                            b_format=fmt, **kw)
        torch.cuda.synchronize()
        ok, err = close(got, want, rtol, atol)
        log(f"  check {tag}: max_abs_err={err:.3e} (rtol={rtol}, atol={atol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(tag)
        return err

    # -- the serving path's shapes, bf16 activations and weights ------------
    # bf16 output: both sides accumulate in f32 in different orders, then
    # round to bf16 (2^-8 relative), hence rtol 2e-2.
    main_err = 0.0
    for (k, n) in OLMO_SHAPES:
        w = randn(k, n, std=0.02).to(torch.bfloat16)
        fmt = tf.TileFormat(bk=128, bn=64, dtype="bfloat16")
        copies = max(1, min(16, math.ceil(128e6 / (k * n * 2))))
        bps = [ref.pack_b_ref(w, fmt)] + [ref.pack_b_ref(
            randn(k, n, std=0.02).to(torch.bfloat16), fmt)
            for _ in range(copies - 1)]
        b_nat = [ref.unpack_b_ref(bp, k, n) for bp in bps]
        for m in (4, 512):
            a = randn(m, k).to(torch.bfloat16)
            bm = min(64, -(-m // 16) * 16)
            for epi in (("none", "silu") if (k, n) == (2048, 8192)
                        else ("none",)):
                main_err = max(main_err, check(
                    f"bf16 M={m} K={k} N={n} {epi}", a, bps[0], n, fmt,
                    2e-2, 1e-3, bm=bm, epilogue=epi))
            # Round-robin over `copies` packed weights (>= 128 MB in all) so
            # that B comes from HBM, not from the 50 MB L2, as in serving.
            reps = 20 if m == 4 else 5
            t_k = time_ms(lambda i: gp.gemm_packed_fused_a(
                a, bps[i % copies], n, bm=bm, b_format=fmt), reps)
            t_p = time_ms(lambda i: gp.gemm_packed_fused_a_plain(
                a, bps[i % copies], n, bm=bm, b_format=fmt), max(2, reps // 4))
            t_l = time_ms(lambda i: torch.matmul(a, b_nat[i % copies]), reps)
            b_bytes = fmt.packed_bytes(k, n)
            t_b, by = bound_ms(m, k, n, 2, b_bytes, 2, H100_BF16_FLOPS)
            variant = gp.pick_variant(a.dtype, fmt, m)
            table.append(dict(m=m, k=k, n=n, variant=variant, ms=t_k,
                              plain_ms=t_p, library_ms=t_l, bound_ms=t_b,
                              bound_by=by))
            log(f"  time M={m} K={k} N={n}: kernel {t_k:.4f} ms (variant "
                f"{variant}), plain {t_p:.4f} ms, "
                f"torch.matmul {t_l:.4f} ms, bound {t_b:.4f} ms ({by})")
        del bps, b_nat

    # -- f32, quantized B, both layouts, bias, every epilogue ---------------
    # f32: full-f32 accumulation on both sides, summation order differs.
    for layout in ("row", "col"):
        m, k, n = 37, 300, 200
        a = randn(m, k)
        w = randn(k, n, std=0.05)
        bias = randn(n)
        fmt = tf.TileFormat(bk=64, bn=64, layout=layout)
        bp = ref.pack_b_ref(w, fmt)
        for epi in ("none", "relu", "gelu", "silu", "tanh"):
            check(f"f32 {layout} {epi}+bias M={m} K={k} N={n}", a, bp, n, fmt,
                  1e-4, 1e-4, bm=48, epilogue=epi, bias=bias)
        check(f"f32 {layout} strided-A alpha/beta/c", randn(m, k + 20)[:, 5:k + 5],
              bp, n, fmt, 1e-4, 1e-4, bm=16, c=randn(m, n), alpha=1.5,
              beta=0.5)
        for qd in ("int8", "int4"):
            for gran in ("tile", "col"):
                qf = tf.TileFormat(bk=64, bn=64, layout=layout, dtype=qd,
                                   scale=tf.ScaleSpec(granularity=gran))
                q, s = ref.pack_b_ref(w, qf)
                check(f"f32 A x {qd}:{gran} {layout} gelu+bias", a, q, n, qf,
                      1e-4, 1e-4, scales=s, bm=32, epilogue="gelu", bias=bias)
    for qd in ("int8", "int4"):
        for gran in ("tile", "col"):
            qf = tf.TileFormat(bk=128, bn=64, dtype=qd,
                               scale=tf.ScaleSpec(granularity=gran))
            q, s = ref.pack_b_ref(randn(2048, 8192, std=0.02), qf)
            for m in (4, 512):
                a = randn(m, 2048).to(torch.bfloat16)
                check(f"bf16 A x {qd}:{gran} M={m} K=2048 N=8192 silu", a, q,
                      8192, qf, 2e-2, 1e-3, scales=s,
                      bm=min(64, -(-m // 16) * 16), epilogue="silu")
    ai = torch.randint(-100, 100, (33, 200), generator=gen, device=dev,
                       dtype=torch.int8)
    wi = torch.randint(-100, 100, (200, 96), generator=gen, device=dev,
                       dtype=torch.int8)
    fi = tf.TileFormat(bk=64, bn=32, dtype="int8")
    check("int8 A x int8 B -> int32 (exact)", ai, ref.pack_b_ref(wi, fi), 96,
          fi, 0.0, 0.0, bm=48, out_dtype=torch.int32)
    if fails:
        raise AssertionError(f"kernel disagrees with its plain version: {fails}")
    return table, main_err


def phase_serve(torch, gp, cfgs, models, serve):
    """Full-width olmo-1b served through the packed path."""
    cfg = cfgs.get_config("olmo-1b")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = models.build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(0)
    engine = serve.Engine(model, params, serve.ServeConfig(
        max_len=256, pack_weights=True, cache_dtype="bfloat16"),
        device=DEVICE)
    del params
    torch.cuda.synchronize()
    log(f"  olmo-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; init + pack {time.perf_counter() - t0:.1f} s; "
        f"dispatch {engine.dispatch_report}")
    gen = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen)
    steps = 32
    per_forward = 7 * cfg.num_layers + 1

    # -- the main path, counted -------------------------------------------
    gp.gemm_packed_fused_a.launches = 0
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=steps)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = gp.gemm_packed_fused_a.launches
    log(f"  generate 4x128 + {steps} steps: {t_gen * 1e3:.1f} ms; "
        f"gemm_packed_fused_a launches {launches} (want {per_forward} x "
        f"{steps + 1} = {per_forward * (steps + 1)})")
    if launches != per_forward * (steps + 1):
        raise AssertionError(f"launch count {launches} != "
                             f"{per_forward * (steps + 1)}")
    if tokens.shape != (4, steps) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    log(f"  tokens[0][:8] = {tokens[0][:8].tolist()}")

    # -- logits against the plain version on the card ----------------------
    # The reference forward swaps the kernel for its plain version where the
    # packed-weight lowering calls it, for this one prefill only.
    from repro_torch.core import layered
    logits_k, _ = engine.prefill_request(prompt[0])
    layered.gemm_packed_fused_a = gp.gemm_packed_fused_a_plain
    try:
        logits_p, _ = engine.prefill_request(prompt[0])
    finally:
        layered.gemm_packed_fused_a = gp.gemm_packed_fused_a
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits")
    diff = (logits_k - logits_p).float()
    rel = float(diff.norm() / logits_p.float().norm())
    max_err = float(diff.abs().max())
    # bf16 activations are rounded (2^-8 relative) after every projection of
    # 16 random-weight layers, in a different summation order on each side,
    # and the differences grow layer by layer (1.9e-2 measured on an H100):
    # limit 5e-2 relative (Frobenius), and the same greedy token. A wrong
    # kernel gives errors of order 1.
    same_tok = int(logits_k.argmax()) == int(logits_p.argmax())
    log(f"  prefill logits kernel vs plain: rel_fro={rel:.3e} (limit 5e-2), "
        f"max_abs_err={max_err:.3e}, |logits|max={float(logits_p.abs().max()):.3f}, "
        f"same argmax {same_tok}")
    if rel > 5e-2 or not same_tok:
        raise AssertionError("served logits disagree with the plain version")

    # -- timings -----------------------------------------------------------
    # End to end: warm Engine.generate calls on the host clock (each step
    # samples and copies its tokens to the host). 32 steps against 1 step
    # gives the decode step; the 1-step call is prefill + sample + one step.
    def gen_ms(n_new, reps=3):
        engine.generate({"tokens": prompt}, max_new_tokens=n_new)
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.generate({"tokens": prompt}, max_new_tokens=n_new)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps
    ms_gen = gen_ms(steps)
    ms_gen1 = gen_ms(1)
    ms_step = (ms_gen - ms_gen1) / (steps - 1)
    log(f"  Engine.generate 4x128 (warm, mean of 3): {steps} steps "
        f"{ms_gen:.2f} ms, 1 step {ms_gen1:.2f} ms; decode "
        f"{ms_step:.3f} ms/step = {4e3 / ms_step:.1f} tokens/s (batch 4); "
        f"{4e3 * steps / ms_gen:.1f} tokens/s over the whole call")

    # Model forwards alone (CUDA events): no sampling, no host copy.
    tok_t = prompt.to(DEVICE)
    ms_prefill = time_ms(lambda i: engine._prefill(tok_t), 3)
    _, caches = engine._prefill(tok_t)
    tok = torch.zeros((4, 1), dtype=torch.long, device=DEVICE)
    pos0 = 128

    def step(i):
        pos = torch.full((4,), pos0 + i % 64, dtype=torch.long,
                         device=DEVICE)
        engine._decode(caches, tok, pos)
    ms_decode = time_ms(step, 16)
    log(f"  model forward alone: prefill 4x128 {ms_prefill:.2f} ms; decode "
        f"{ms_decode:.3f} ms/step")

    # -- where a decode step's time goes (torch.profiler, CUPTI) ------------
    from torch.profiler import ProfilerActivity, profile
    steps_p = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps_p):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            dev[ev.key] = t
    busy = sum(dev.values())
    k1 = sum(t for name, t in dev.items() if "fused_a" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    # The profiler slows the host (wall below); the busy share is taken
    # against the unprofiled step times measured above.
    busy_ms = busy / steps_p / 1e3
    log(f"  profile {steps_p} decode steps: wall {wall_us / steps_p / 1e3:.3f} ms/step "
        f"(profiled), device busy {busy_ms:.3f} ms/step = "
        f"{100 * busy_ms / ms_decode:.1f}% of the unprofiled forward "
        f"({100 * busy_ms / ms_step:.1f}% of the generate step), K1 "
        f"{k1 / steps_p / 1e3:.3f} ms/step, {len(dev)} kernel names")
    for name, t in top:
        log(f"    {t / steps_p / 1e3:8.3f} ms/step  {name[:90]}")
    return launches, dict(generate_ms=ms_gen, generate_1_step_ms=ms_gen1,
                          decode_ms_per_step=ms_step,
                          tokens_per_s=4e3 / ms_step,
                          model_prefill_ms=ms_prefill,
                          model_decode_ms=ms_decode, rel_fro=rel,
                          first_generate_ms=t_gen * 1e3,
                          decode_device_busy_share=busy_ms / ms_decode,
                          generate_device_busy_share=busy_ms / ms_step,
                          decode_k1_device_ms=k1 / steps_p / 1e3)


def main() -> int:
    try:
        import torch
        from repro_torch import configs as cfgs
        from repro_torch import models, serve
        from repro_torch.core import tile_format as tf
        from repro_torch.kernels import build
        from repro_torch.kernels import gemm_packed as gp
        from repro_torch.kernels import ref
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the "
              f"repo root", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a GPU", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    card = card_line()
    log(f"card: {card}")

    log("phase 1: build + kernel vs plain")
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        lines = path.with_suffix(".log").read_text().splitlines() \
            if path.with_suffix(".log").exists() else []
        for line in lines:
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")
    table, main_err = phase_kernels(torch, gp, ref, tf)

    log("phase 2: serve full-width olmo-1b")
    launches, serve_t = phase_serve(torch, gp, cfgs, models, serve)

    # One decode forward (batch 4) of K1 calls: the per-shape times weighted
    # by each shape's count in one forward (x 16 layers; the head once).
    layers = cfgs.get_config("olmo-1b").num_layers
    count = {s: (c * layers if c else 1) for s, c in OLMO_SHAPES.items()}
    dec = [r for r in table if r["m"] == 4]
    agg = {key: sum(r[key] * count[(r["k"], r["n"])] for r in dec)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    summary = {"kernels": [{
        "name": "gemm_packed_fused_a", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_packed_fused_a.cu",
        "replaces": "src/repro/kernels/gemm_packed.py:162",
        "launches": launches, "max_abs_err": main_err,
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                     else "operations"),
        "library_ms": agg["library_ms"],
        "work": "one decode forward of olmo-1b, batch 4 (113 calls)",
        "shapes": table, "serve": serve_t, "card": card}]}
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase failing fails the run, with its traceback
        traceback.print_exc()
        sys.exit(1)
