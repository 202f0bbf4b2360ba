"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once, into ``build/kernels/``) and hold each kernel
     against its plain torch version on the card:
     - gemm_packed_fused_a (K1) at olmo-1b's serving shapes in bf16, plus
       f32, int8 and int4 B with tile and col scales, both tile layouts,
       bias and every epilogue;
     - gemm_grouped_packed_ragged (K2) and gemm_grouped_packed (K3, the
       same operands with every row live) at mixtral-8x22b's expert shapes
       (the gate/up pair K=6144 N=16384, the down projection K=16384
       N=6144, 8 experts) at the decode envelope (C=8) and the prefill
       envelope (C=160), plus S>1, int8/int4 tile/col, both layouts, bias,
       every epilogue, f32 and int8 activations. Rows past the counts must
       be exactly 0.
  2. Serve full-width olmo-1b (16 layers, d_model 2048, vocab 50304, bf16,
     random weights from a seed, made on the card) through
     ``Engine(..., ServeConfig(pack_weights=True))``: prompt batch 4 x 128,
     then 32 greedy decode steps. The kernel launch counts are set to 0
     just before ``Engine.generate`` and read just after; the first
     prefill's logits are compared with the same weights run through the
     plain versions on the card.
  3. Serve mixtral-8x22b at its published widths (d_model 6144, 48 heads /
     8 KV heads x 128, d_ff 16384, 8 experts top-2, vocab 32768) with its
     depth cut to 4 of 56 layers — the only cut, forced by memory (4
     layers of f32 weights are 40 GB, plus 20 GB packed in bf16) — the
     same way: K1 and K2 launches counted around ``Engine.generate``,
     prefill logits against the plain versions, expert choices compared.
  Timings, for each served model: warm Engine.generate calls (decode
  ms/step and tokens/s end to end), the model's prefill and decode
  forwards alone, a profile of the decode forward; for each kernel shape
  its time beside its bound, its plain version and one PyTorch call.
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

# mixtral-8x22b at its published widths; depth cut to 4 of 56 layers.
MIXTRAL_LAYERS = 4
MIX_E, MIX_D, MIX_F = 8, 6144, 16384
PROMPT, STEPS, MAX_LEN = (4, 128), 32, 256


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


def route_counts(torch, gen, tokens, probs, cap):
    """Counts [E] of ``tokens`` tokens routed top-2 (two distinct experts
    each, drawn with weights ``probs``), capped at the capacity ``cap``."""
    w = torch.tensor(probs, dtype=torch.float32)
    picks = torch.stack([torch.multinomial(w, 2, generator=gen)
                         for _ in range(tokens)])
    counts = torch.bincount(picks.flatten(), minlength=len(probs))
    return counts.clamp(max=cap).to(torch.int32)


def grouped_bound_ms(counts, e, c, k, n, b_bytes, pair):
    """Least time of one grouped call: operations over the bf16 peak
    against bytes over the HBM rate. Only live work counts: the live rows'
    products and A rows, the packed B (+ B2) of the experts with a live row
    (dead segments fetch nothing), and the whole [E, C, N] bf16 output,
    zeros included. ``counts`` [E] on the host, or None: every row live;
    ``b_bytes`` one expert's packed bytes."""
    live_rows = e * c if counts is None else int(counts.sum())
    live_e = e if counts is None else int((counts > 0).sum())
    streams = 2 if pair else 1
    flops = 2.0 * live_rows * k * n * streams
    nbytes = live_e * b_bytes * streams + live_rows * k * 2 + e * c * n * 2
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_grouped(torch, gg, ref, tf):
    """K2 and K3 against their plain versions on the card, and their times
    at mixtral-8x22b's expert shapes; returns (timing rows, max abs error
    at the main shapes)."""
    import torch.nn.functional as F
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(2)
    cpu_gen = torch.Generator().manual_seed(3)
    fails = []
    rows = []

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def check(tag, a, bp, n, counts, rtol, atol, **kw):
        """K2 on [E, S, C, K] and K3 on the same A as [E, S*C, K]."""
        e, s, c, k = a.shape
        got = gg.gemm_grouped_packed_ragged(a, bp, n, counts, **kw)
        torch.cuda.synchronize()
        want = gg.gemm_grouped_packed_ragged_plain(a, bp, n, counts, **kw)
        ok, err = close(got, want, rtol, atol)
        mask = ref.ragged_row_mask(c, counts.clamp(0, c))
        zeros = not bool(got[~mask].any())
        got3 = gg.gemm_grouped_packed(a.reshape(e, s * c, k), bp, n, **kw)
        torch.cuda.synchronize()
        want3 = gg.gemm_grouped_packed_plain(a.reshape(e, s * c, k), bp, n,
                                             **kw)
        ok3, err3 = close(got3, want3, rtol, atol)
        good = ok and zeros and ok3
        log(f"  check {tag}: K2 max_abs_err={err:.3e} zeros past counts "
            f"{zeros}, K3 max_abs_err={err3:.3e} (rtol={rtol}, atol={atol}) "
            f"{'ok' if good else 'FAIL'}")
        if not good:
            fails.append(tag)
        return max(err, err3)

    # -- the main path's shapes: bf16, E=8, decode and prefill envelopes ----
    # Decode: 4 tokens x top-2 over 8 experts, capacity 8 (the routing
    # group of 4 tokens). Prefill: 4 x 128 = 512 tokens, capacity 160, drawn
    # with skewed weights (expert 0 never picked) so that some segments are
    # 0, some partial and some full.
    fmt = tf.TileFormat(bk=128, bn=64, dtype="bfloat16")
    envelopes = {
        "decode": (8, route_counts(torch, cpu_gen, 4, [1.0] * MIX_E, 8)),
        "prefill": (160, route_counts(torch, cpu_gen, 512,
                                      [0, 3, 2.5, 1, 2, 0.4, 1, 2], 160))}
    for env, (c, counts) in envelopes.items():
        log(f"  {env} envelope C={c}: counts {counts.tolist()}")
    main_err = 0.0
    for name, k, n, pair in (("gate_up", MIX_D, MIX_F, True),
                             ("down", MIX_F, MIX_D, False)):
        w_nat = [randn(MIX_E, k, n, std=0.02, dtype=torch.bfloat16)
                 for _ in range(2 if pair else 1)]
        packed = [ref.pack_b_grouped_ref(w, fmt) for w in w_nat]
        kw = dict(b_format=fmt, epilogue="silu_gate" if pair else "none",
                  b2_packed=packed[1] if pair else None)
        b_bytes = fmt.packed_bytes(k, n)
        for env, (c, counts_h) in envelopes.items():
            counts = counts_h.reshape(MIX_E, 1).to(dev)
            a = randn(MIX_E, 1, c, k, dtype=torch.bfloat16)
            rows_live = ref.ragged_row_mask(c, counts)[..., None]
            a = torch.where(rows_live, a, torch.zeros((), dtype=a.dtype,
                                                      device=dev))
            main_err = max(main_err, check(
                f"mixtral {name} {env} E=8 C={c} K={k} N={n}", a, packed[0],
                n, counts, 2e-2, 1e-3, **kw))
            a3 = a.reshape(MIX_E, c, k)

            def lib(i):
                out = torch.bmm(a3, w_nat[0])
                if pair:
                    out = F.silu(out) * torch.bmm(a3, w_nat[1])
                return out
            reps = 5 if env == "decode" else 3
            t = dict(
                k2=time_ms(lambda i: gg.gemm_grouped_packed_ragged(
                    a, packed[0], n, counts, **kw), reps),
                k2_plain=time_ms(lambda i: gg.gemm_grouped_packed_ragged_plain(
                    a, packed[0], n, counts, **kw), 2),
                k3=time_ms(lambda i: gg.gemm_grouped_packed(
                    a3, packed[0], n, **kw), reps),
                k3_plain=time_ms(lambda i: gg.gemm_grouped_packed_plain(
                    a3, packed[0], n, **kw), 2),
                library=time_ms(lib, reps))
            b2, by2 = grouped_bound_ms(counts_h, MIX_E, c, k, n, b_bytes, pair)
            b3, by3 = grouped_bound_ms(None, MIX_E, c, k, n, b_bytes, pair)
            variant = gg.pick_variant(a.dtype, fmt, c)
            rows.append(dict(contraction=name, envelope=env, e=MIX_E, s=1,
                             c=c, k=k, n=n, counts=counts_h.tolist(),
                             variant=variant, k2_ms=t["k2"],
                             k2_plain_ms=t["k2_plain"], k2_bound_ms=b2,
                             k2_bound_by=by2, k3_ms=t["k3"],
                             k3_plain_ms=t["k3_plain"], k3_bound_ms=b3,
                             k3_bound_by=by3, library_ms=t["library"]))
            log(f"  time {name} {env} C={c} (variant {variant}): K2 "
                f"{t['k2']:.4f} ms (bound {b2:.4f}, {by2}; plain "
                f"{t['k2_plain']:.4f}), K3 {t['k3']:.4f} ms (bound {b3:.4f}, "
                f"{by3}; plain {t['k3_plain']:.4f}), torch.bmm"
                f"{' x2 + silu*mul' if pair else ''} {t['library']:.4f} ms")
        del w_nat, packed

    # -- formats, layouts, S > 1, bias, every epilogue, f32 / int8 A -------
    e, s, k, n = 3, 2, 300, 200
    w, w2 = randn(e, k, n, std=0.05), randn(e, k, n, std=0.05)
    bias = randn(e, n)
    formats = [("bfloat16", None)] + [(q, g) for q in ("int8", "int4")
                                      for g in ("tile", "col")]
    for c in (8, 40):   # decode and prefill blocks of the tensor-core kernel
        counts = torch.tensor([[0, c], [c // 2, 1], [c + 7, -2]],
                              dtype=torch.int32, device=dev)
        for layout in ("row", "col"):
            for qd, gran in formats:
                scale = dict(scale=tf.ScaleSpec(granularity=gran)) if gran else {}
                qf = tf.TileFormat(bk=64, bn=64, layout=layout, dtype=qd, **scale)
                if gran:
                    (bp, sc), (b2p, sc2) = (ref.pack_b_grouped_ref(w, qf),
                                            ref.pack_b_grouped_ref(w2, qf))
                else:
                    bp, b2p = (ref.pack_b_grouped_ref(x.to(torch.bfloat16), qf)
                               for x in (w, w2))
                    sc = sc2 = None
                a = randn(e, s, c, k, dtype=torch.bfloat16)
                check(f"bf16 A x {qd}:{gran} {layout} silu_gate C={c}", a, bp,
                      n, counts, 2e-2, 1e-3, b2_packed=b2p, b_scales=sc,
                      b2_scales=sc2, b_format=qf, epilogue="silu_gate")
                if gran:  # f32 activations: the scalar-FMA kernel, full f32
                    check(f"f32 A x {qd}:{gran} {layout} gelu+bias C={c}",
                          randn(e, s, c, k), bp, n, counts, 1e-4, 1e-4,
                          b_scales=sc, b_format=qf, epilogue="gelu",
                          bias=bias)
        qf = tf.TileFormat(bk=64, bn=64, dtype="int8", scale=tf.ScaleSpec())
        bp, sc = ref.pack_b_grouped_ref(w, qf)
        for epi in ("none", "relu", "gelu", "silu", "tanh"):
            check(f"bf16 A x int8:tile {epi}+bias C={c}",
                  randn(e, s, c, k, dtype=torch.bfloat16), bp, n, counts,
                  2e-2, 1e-3, b_scales=sc, b_format=qf, epilogue=epi,
                  bias=bias)
            check(f"f32 A x f32 {epi}+bias C={c}", randn(e, s, c, k),
                  ref.pack_b_grouped_ref(w, tf.TileFormat(bk=32, bn=64)), n,
                  counts, 1e-4, 1e-4, epilogue=epi, bias=bias)
    ai = torch.randint(-100, 100, (e, s, 24, k), generator=gen, device=dev,
                       dtype=torch.int8)
    wi = torch.randint(-100, 100, (e, k, 96), generator=gen, device=dev,
                       dtype=torch.int8)
    fi = tf.TileFormat(bk=64, bn=32, dtype="int8")
    check("int8 A x int8 B -> int32 (exact)", ai, ref.pack_b_grouped_ref(wi, fi),
          96, torch.tensor([[24, 3], [0, 30], [11, 24]], dtype=torch.int32,
                           device=dev), 0.0, 0.0, b_format=fi,
          out_dtype=torch.int32)
    if fails:
        raise AssertionError(f"grouped kernel disagrees with its plain "
                             f"version: {fails}")
    return rows, main_err


def serve_timings(torch, engine, prompt, steps, kernel_tags):
    """Warm Engine.generate calls, the forwards alone, and a profile of the
    decode forward. ``kernel_tags`` maps a label to a substring of the CUDA
    kernel names, for their device time per decode step."""
    # End to end: warm Engine.generate calls on the host clock (each step
    # samples and copies its tokens to the host). `steps` steps against 1
    # step gives the decode step; the 1-step call is prefill + sample + one
    # step.
    b = prompt.shape[0]

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
    log(f"  Engine.generate {b}x{prompt.shape[1]} (warm, mean of 3): {steps} "
        f"steps {ms_gen:.2f} ms, 1 step {ms_gen1:.2f} ms; decode "
        f"{ms_step:.3f} ms/step = {b * 1e3 / ms_step:.1f} tokens/s (batch "
        f"{b}); {b * 1e3 * steps / ms_gen:.1f} tokens/s over the whole call")

    # Model forwards alone (CUDA events): no sampling, no host copy.
    tok_t = prompt.to(DEVICE)
    ms_prefill = time_ms(lambda i: engine._prefill(tok_t), 3)
    _, caches = engine._prefill(tok_t)
    tok = torch.zeros((b, 1), dtype=torch.long, device=DEVICE)
    pos0 = prompt.shape[1]

    def step(i):
        pos = torch.full((b,), pos0 + i % 64, dtype=torch.long, device=DEVICE)
        engine._decode(caches, tok, pos)
    ms_decode = time_ms(step, 16)
    log(f"  model forward alone: prefill {b}x{prompt.shape[1]} "
        f"{ms_prefill:.2f} ms; decode {ms_decode:.3f} ms/step")

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
    per_kernel = {label: sum(t for name, t in dev.items() if tag in name)
                  / steps_p / 1e3 for label, tag in kernel_tags.items()}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    # The profiler slows the host (wall below); the busy share is taken
    # against the unprofiled step times measured above.
    busy_ms = busy / steps_p / 1e3
    log(f"  profile {steps_p} decode steps: wall {wall_us / steps_p / 1e3:.3f} ms/step "
        f"(profiled), device busy {busy_ms:.3f} ms/step = "
        f"{100 * busy_ms / ms_decode:.1f}% of the unprofiled forward "
        f"({100 * busy_ms / ms_step:.1f}% of the generate step), "
        + ", ".join(f"{label} {ms:.3f} ms/step" for label, ms in per_kernel.items())
        + f", {len(dev)} kernel names")
    for name, t in top:
        log(f"    {t / steps_p / 1e3:8.3f} ms/step  {name[:90]}")
    return dict(generate_ms=ms_gen, generate_1_step_ms=ms_gen1,
                decode_ms_per_step=ms_step, tokens_per_s=b * 1e3 / ms_step,
                model_prefill_ms=ms_prefill, model_decode_ms=ms_decode,
                decode_device_busy_share=busy_ms / ms_decode,
                generate_device_busy_share=busy_ms / ms_step,
                decode_device_ms={k: v for k, v in per_kernel.items()})


def phase_serve(torch, gp, cfgs, models, serve):
    """Full-width olmo-1b served through the packed path."""
    cfg = cfgs.get_config("olmo-1b")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = models.build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(0)
    engine = serve.Engine(model, params, serve.ServeConfig(
        max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16"),
        device=DEVICE)
    del params
    torch.cuda.synchronize()
    log(f"  olmo-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; init + pack {time.perf_counter() - t0:.1f} s; "
        f"dispatch {engine.dispatch_report}")
    gen = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)
    per_forward = 7 * cfg.num_layers + 1

    # -- the main path, counted -------------------------------------------
    gp.gemm_packed_fused_a.launches = 0
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = gp.gemm_packed_fused_a.launches
    log(f"  generate {PROMPT[0]}x{PROMPT[1]} + {STEPS} steps: {t_gen * 1e3:.1f} ms; "
        f"gemm_packed_fused_a launches {launches} (want {per_forward} x "
        f"{STEPS + 1} = {per_forward * (STEPS + 1)})")
    if launches != per_forward * (STEPS + 1):
        raise AssertionError(f"launch count {launches} != "
                             f"{per_forward * (STEPS + 1)}")
    check_tokens(tokens, cfg)

    # -- logits against the plain version on the card ----------------------
    # The reference forward swaps the kernel for its plain version where the
    # packed-weight lowering calls it, for this one prefill only.
    logits_k, _ = engine.prefill_request(prompt[0])
    with plain_kernels(gp, None):
        logits_p, _ = engine.prefill_request(prompt[0])
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits")
    rel, max_err, same_tok = compare_logits(torch, logits_k, logits_p)
    # bf16 activations are rounded (2^-8 relative) after every projection of
    # 16 random-weight layers, in a different summation order on each side,
    # and the differences grow layer by layer (1.9e-2 measured on an H100):
    # limit 5e-2 relative (Frobenius), and the same greedy token. A wrong
    # kernel gives errors of order 1.
    log(f"  prefill logits kernel vs plain: rel_fro={rel:.3e} (limit 5e-2), "
        f"max_abs_err={max_err:.3e}, |logits|max={float(logits_p.abs().max()):.3f}, "
        f"same argmax {same_tok}/1")
    if rel > 5e-2 or same_tok != 1:
        raise AssertionError("served logits disagree with the plain version")

    timings = serve_timings(torch, engine, prompt, STEPS, {"K1": "fused_a"})
    timings.update(rel_fro=rel, first_generate_ms=t_gen * 1e3)
    return launches, timings


def check_tokens(tokens, cfg):
    if tokens.shape != (PROMPT[0], STEPS) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    log(f"  tokens[0][:8] = {tokens[0][:8].tolist()}")


class plain_kernels:
    """Within the block, the packed-weight lowerings call the plain
    versions of K1 (and of K2/K3 when ``gg`` is given) instead of the
    kernels."""

    def __init__(self, gp, gg):
        from repro_torch.core import layered
        self.layered = layered
        self.swaps = {"gemm_packed_fused_a": gp.gemm_packed_fused_a_plain}
        if gg is not None:
            self.swaps.update(
                gemm_grouped_packed_ragged=gg.gemm_grouped_packed_ragged_plain,
                gemm_grouped_packed=gg.gemm_grouped_packed_plain)

    def __enter__(self):
        self.saved = {k: getattr(self.layered, k) for k in self.swaps}
        for k, fn in self.swaps.items():
            setattr(self.layered, k, fn)

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.layered, k, fn)


def compare_logits(torch, got, want):
    """(relative Frobenius error, max abs error, rows with the same argmax)."""
    diff = (got - want).float()
    rel = float(diff.norm() / want.float().norm())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    return rel, float(diff.abs().max()), same


def phase_mixtral(torch, gp, gg, cfgs, models, serve):
    """mixtral-8x22b at its published widths, 4 of 56 layers, served through
    the packed path: K1 for attention and the LM head, K2 for the experts."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(cfgs.get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS,
                              compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    model = models.build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(0)
    raw_gb = torch.cuda.memory_allocated() / 1e9
    engine = serve.Engine(model, params, serve.ServeConfig(
        max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16"),
        device=DEVICE)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  mixtral-8x22b: {cfg.num_layers} of 56 layers (depth is the only "
        f"cut, forced by memory), d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window}; init + pack "
        f"{time.perf_counter() - t0:.1f} s; raw f32 weights {raw_gb:.1f} GB, "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, packed "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB; dispatch "
        f"{engine.dispatch_report}")
    gen = torch.Generator(device="cpu").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)
    want_k1 = (4 * cfg.num_layers + 1) * (STEPS + 1)
    want_k2 = 2 * cfg.num_layers * (STEPS + 1)

    # -- the main path, counted -------------------------------------------
    gp.gemm_packed_fused_a.launches = 0
    gg.gemm_grouped_packed_ragged.launches = 0
    gg.gemm_grouped_packed.launches = 0
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(k1=gp.gemm_packed_fused_a.launches,
                    k2=gg.gemm_grouped_packed_ragged.launches,
                    k3=gg.gemm_grouped_packed.launches)
    log(f"  generate 4x128 + {STEPS} steps: {t_gen * 1e3:.1f} ms; launches "
        f"K1 {launches['k1']} (want {want_k1}), K2 {launches['k2']} (want "
        f"{want_k2}), K3 {launches['k3']} (want 0: the model always passes "
        f"counts)")
    if (launches["k1"], launches["k2"], launches["k3"]) != (want_k1, want_k2, 0):
        raise AssertionError(f"launch counts {launches}")
    check_tokens(tokens, cfg)

    # -- logits against the plain versions on the card ---------------------
    # Each layer's routing is recorded (the experts each token chose). The
    # plain run computes its own routing, whose choices are compared with
    # the kernel run's; its logits are compared twice: free (its own
    # routing) and pinned (the kernel run's routing replayed, so that only
    # the expert products differ).
    real_route = moe.route
    runs = {"kernel": [], "free": [], "pinned": []}

    def recording(run, replay=None):
        def fn(cfg_, w, x):
            out = real_route(cfg_, w, x)
            runs[run].append(out)
            return out if replay is None else replay[len(runs[run]) - 1]
        return fn

    tok_t = prompt.to(DEVICE)
    try:
        moe.route = recording("kernel")
        logits_k, _ = engine._prefill(tok_t)
        with plain_kernels(gp, gg):
            moe.route = recording("free")
            logits_f, _ = engine._prefill(tok_t)
            moe.route = recording("pinned", replay=runs["kernel"])
            logits_p, _ = engine._prefill(tok_t)
    finally:
        moe.route = real_route
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits")

    def flips(run):
        """(token, layer) pairs whose chosen experts differ from the
        kernel run's."""
        return sum(int(((a[0].sum(-1) > 0) != (b[0].sum(-1) > 0)).any(-1).sum())
                   for a, b in zip(runs["kernel"], runs[run]))
    n_choices = prompt.numel() * cfg.num_layers
    flips_free, flips_pinned = flips("free"), flips("pinned")
    rel_f, err_f, same_f = compare_logits(torch, logits_k, logits_f)
    rel_p, err_p, same_p = compare_logits(torch, logits_k, logits_p)
    # Error analysis. Pinned: the two runs differ only in the rounding of
    # bf16 activations after each projection (2^-8 relative), summed in
    # other orders, over 4 layers; olmo-1b's 16 layers measure 1.9e-2 to
    # 2.4e-2 on an H100, so the limit is 5e-2 relative (Frobenius), as for
    # olmo-1b. A wrong kernel gives errors of order 1. Free: a token whose
    # two best router logits are within those rounding differences (~1e-2
    # of logits of scale ~1.6) picks another expert, which changes about
    # half of its MoE output; if that token is a last position, its logits
    # move by a few tenths. The free run is held to 0.5, which still
    # catches a wrong kernel (uncorrelated logits differ by about 1.4).
    log(f"  expert choices (token, layer) that differ from the kernel run: "
        f"free plain run {flips_free} of {n_choices}, pinned plain run's own "
        f"router {flips_pinned} of {n_choices}")
    log(f"  prefill logits kernel vs plain, routing pinned: rel_fro={rel_p:.3e} "
        f"(limit 5e-2), max_abs_err={err_p:.3e}, same argmax {same_p}/4; "
        f"routing free: rel_fro={rel_f:.3e} (limit 0.5), max_abs_err="
        f"{err_f:.3e}, same argmax {same_f}/4; |logits|max="
        f"{float(logits_k.abs().max()):.3f}")
    if rel_p > 5e-2 or rel_f > 0.5:
        raise AssertionError("served logits disagree with the plain versions")
    counts = [r[3]["counts"].tolist() for r in runs["kernel"]]
    dropped = [int(r[3]["dropped"]) for r in runs["kernel"]]
    log(f"  prefill routing per layer: counts {counts}, dropped {dropped}")
    del runs

    timings = serve_timings(torch, engine, prompt, STEPS,
                            {"K1": "fused_a", "K2": "grouped_"})
    timings.update(rel_fro_pinned=rel_p, rel_fro_free=rel_f,
                   expert_choice_flips_free=flips_free,
                   expert_choices=n_choices, first_generate_ms=t_gen * 1e3,
                   prefill_counts=counts, prefill_dropped=dropped)
    del engine
    torch.cuda.empty_cache()
    return launches, timings


def main() -> int:
    try:
        import torch
        from repro_torch import configs as cfgs
        from repro_torch import models, serve
        from repro_torch.core import tile_format as tf
        from repro_torch.kernels import build
        from repro_torch.kernels import gemm_grouped as gg
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
    grouped_rows, grouped_err = phase_grouped(torch, gg, ref, tf)
    torch.cuda.empty_cache()

    log("phase 2: serve full-width olmo-1b")
    launches, serve_t = phase_serve(torch, gp, cfgs, models, serve)
    torch.cuda.empty_cache()

    log(f"phase 3: serve mixtral-8x22b, {MIXTRAL_LAYERS} of 56 layers, "
        f"published widths")
    mix_launches, mix_t = phase_mixtral(torch, gp, gg, cfgs, models, serve)

    # One decode forward (batch 4) of K1 calls: the per-shape times weighted
    # by each shape's count in one forward (x 16 layers; the head once).
    layers = cfgs.get_config("olmo-1b").num_layers
    count = {s: (c * layers if c else 1) for s, c in OLMO_SHAPES.items()}
    dec = [r for r in table if r["m"] == 4]
    agg = {key: sum(r[key] * count[(r["k"], r["n"])] for r in dec)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    # One decode forward of the 4-layer mixtral: a gate/up pair and a down
    # projection per layer at the decode envelope (phase 1's counts).
    gdec = [r for r in grouped_rows if r["envelope"] == "decode"]

    def gsum(key):
        return MIXTRAL_LAYERS * sum(r[key] for r in gdec)

    def gby(key):
        return ("bytes" if all(r[key] == "bytes" for r in gdec)
                else "operations")
    grouped_work = (f"one decode forward of {MIXTRAL_LAYERS}-layer "
                    f"mixtral-8x22b, batch 4 ({2 * MIXTRAL_LAYERS} calls: a "
                    f"gate/up pair and a down projection a layer, E=8 C=8)")
    library = ("torch.bmm on natural bf16 weights over the padded "
               "[E, S*C, K] A: two bmm + silu*mul for the pair, one for down")
    summary = {"kernels": [{
        "name": "gemm_packed_fused_a", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_packed_fused_a.cu",
        "replaces": "src/repro/kernels/gemm_packed.py:162",
        "launches": launches + mix_launches["k1"],
        "launches_by_path": {"olmo-1b": launches,
                             "mixtral-8x22b": mix_launches["k1"]},
        "max_abs_err": main_err,
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                     else "operations"),
        "library_ms": agg["library_ms"],
        "work": "one decode forward of olmo-1b, batch 4 (113 calls)",
        "shapes": table, "serve": serve_t, "card": card}, {
        "name": "gemm_grouped_packed_ragged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_grouped_packed.cu",
        "replaces": "src/repro/kernels/gemm_grouped.py:284",
        "launches": mix_launches["k2"], "max_abs_err": grouped_err,
        "ms": gsum("k2_ms"), "plain_ms": gsum("k2_plain_ms"),
        "bound_ms": gsum("k2_bound_ms"), "bound_by": gby("k2_bound_by"),
        "library_ms": gsum("library_ms"), "library": library,
        "work": grouped_work, "shapes": grouped_rows, "serve": mix_t,
        "card": card}, {
        "name": "gemm_grouped_packed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_grouped_packed.cu",
        "replaces": "src/repro/kernels/gemm_grouped.py:112",
        "launches": mix_launches["k3"], "on_main_path": False,
        "max_abs_err": grouped_err,
        "ms": gsum("k3_ms"), "plain_ms": gsum("k3_plain_ms"),
        "bound_ms": gsum("k3_bound_ms"), "bound_by": gby("k3_bound_by"),
        "library_ms": gsum("library_ms"), "library": library,
        "work": grouped_work + "; every row live (no counts)",
        "card": card}]}
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
