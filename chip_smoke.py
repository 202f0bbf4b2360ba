"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --planted-faults   # the checks against a wrong K1, K2, K4-K8
    python3 chip_smoke.py --served-attention OTHER/layers.py   # served attention, A/B

Phases (any failure exits non-zero and prints no result line):
  1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once, into ``build/kernels/``), check that K8's
     library issues no tensor-core instruction, K6's holds HGMMA (wgmma),
     and K1's CUDA-core functions issue none while its wgmma functions
     issue HGMMA (per function: one library holds both), K2 / K3's
     grouped_wgmma HGMMA, grouped_stream HMMA and grouped_fma none, K7's
     wgmma_packed HGMMA, mma_stream HMMA and CUDA-core bodies none, K4's
     flash_wgmma_kernel HGMMA, flash_stream_kernel and flash_mma_kernel
     HMMA and flash_f32_kernel none, and
     hold each kernel against its plain torch version on the card:
     - gemm_packed_fused_a (K1) at olmo-1b's serving shapes in bf16 (M=4 on
       tc_stream, M=512 on wgmma, timed with CUDA events and by
       torch.profiler's kernel time beside torch.matmul's), plus f32, int8
       and int4 B with tile and col scales, both tile layouts, bias and
       every epilogue; then at its bodies' edges (k1_checks: a strided A
       whose columns past K hold NaN, K 700 / 750 / 2048, M 1 ... 512, N
       200 / 8192 / 50304, both layouts with bk 64 and 128, every epilogue
       with c, alpha and beta at M=4 (split K) and 512, a misaligned A on
       mma_general, f32 / int8 on the CUDA-core bodies), each call held to
       the body it must take;
     - gemm_grouped_packed_ragged (K2) and gemm_grouped_packed (K3, the
       same operands with every row live) at mixtral-8x22b's expert shapes
       (the gate/up pair K=6144 N=16384, the down projection K=16384
       N=6144, 8 experts) at the decode envelope (C=8, on tc_stream) and
       the prefill envelope (C=160, on wgmma), timed with CUDA events and
       torch.profiler's kernel time beside torch.bmm's; plus S>1,
       int8/int4 tile/col, both layouts, bias, every epilogue, f32 and
       int8 activations on PR 12's bodies; then at the TMA bodies' edges
       (k2_checks: C 1 / 8 / 16 / 17 / 160 / 300, counts 0, partial, C, > C and
       negative, K 700, N 200 and 136, the pair with B != B2, every
       epilogue with bias, split K and not, f16, a permuted A, a
       misaligned A on mma_sync), each call held to the body it must take.
       Rows past the counts must be exactly 0;
     - pack_a / pack_b / pack_b_grouped (K5) byte-equal to the plain
       packers (k5_checks: f32, bf16, int8, int4; row and col; tile and
       col scales; odd shapes; padded and transposed sources; tiles 16 ...
       256 and over; odd offsets, strided columns, 8-byte elements;
       extent-1 dims), each call held to the body pack_body names
       (tma_copy, tma_stage, general) under a freed 0xFF block where the
       output lands; K5's SASS per function (UTMALDG and UBLKCP in both
       TMA bodies, neither in general); K5 timed at the served paths'
       shapes (each olmo-1b projection, the LM head as table.t(), one
       mixtral-8x22b expert stack) in events and device time beside its
       byte bound, torch's one-call strided copy and its general body;
       gemm_packed (K6), gemm_tiled (K7,
       also as one block) and matmul_vsx_like (K8, and its packed-B
       variant) in f32, bf16 and int8 at odd shapes, with strided and
       transposed operands, bias, every epilogue and beta * C; K6 and K8
       again at their bodies' edges (M 1 ... 512, N and K off every block,
       K = 8192 at decode so that K splits, A offset by 5 elements, B as
       table.t(), the planner's packed tiles in every layout pair and tiles
       it does not emit), with their launches counted by body; K7 at its
       TMA bodies' edges (k7_checks: A and B as views whose columns past K
       / N hold NaN, B row-major and as table.t(), M 1 ... 512, K 700 /
       2048 / 8192, N 200 / 8192 / 50304, every epilogue split and not,
       f16, one block, a misaligned A on mma_general, f32 / int8 on the
       CUDA-core bodies), each call held to the body tiled_body names; at
       olmo-1b's shapes K7 and K6 must take tc_stream (M=4) / wgmma
       (M=512) and K8 fma_stream / fma_tiled; K8 timed beside torch.matmul
       in bf16 and in f32 with TF32 off (CUDA cores); K7 at bf16 4096 as
       tiling (wgmma) and intrinsic (one block) beside torch.matmul;
     - flash_attention (K4) in f32, bf16 and f16 at the reference test's
       cases, Sq > Skv (rows that see no key exactly 0), a window without
       causal, D = 128 and 256, GQA decode, strided q / k / v views; then
       in bf16 and f16 at its bodies' edges (ATTN_EDGE_CASES: Sq * group
       at 1 ... 18 rows around the stream body's limit, Sq off the row
       tile, Skv off the key tile, Sq < Skv, window edges on and off a
       tile edge, D 64 / 128 / 256), fused-qkv views at prefill and
       decode, heads stored outside the sequence and a misaligned q, each
       call held to the body attention_body names;
     - the quantized TMA bodies of K1 and K2 / K3 (gemm_quant.cuh:
       tc_stream_q at decode, wgmma_q above; their SASS must hold UTMALDG
       and HMMA / HGMMA), kq_checks: int8 / int4 tiles over the whole
       range (-8 and -128 included) with tile or col scales, both layouts,
       K1 at M 1 ... 512 with K 700 split and unsplit, every epilogue with
       bias and beta * C, f16, K2 at C 1 ... 300 over counts 0, partial,
       C, > C and negative, the pair with B != B2, every segment dead, K3,
       a misaligned A on the earlier bodies; each call held to the body
       the route names under a freed NaN block; kq_served: the same
       checks at the served shapes below, int8:tile and int4:col, new body
       and earlier one, tiles over the whole range with scales drawn over
       a 16x range; then kq_times: K1 at
       olmo-1b's decode (113 calls) and prefill (112 calls) shapes, K2 / K3
       at mixtral's decode and prefill envelopes, int8:tile and int4:col,
       new body beside the earlier one (forced through the route) in
       device time and events, against the narrow bytes' bound, the plain
       version and the one-call library op where the card's torch has one
       (``torch._weight_int8pack_mm`` for int8:col,
       ``torch._weight_int4pack_mm`` for int4);
     - every ``repro_torch.kernels.ops`` wrapper once at a small odd shape
       against the plain composition of what it launches, with its
       launches counted (packed_matmul = 2 K5 + 1 K6, and so on).
  2. Serve full-width olmo-1b (16 layers, d_model 2048, vocab 50304, bf16,
     random weights from a seed, made on the card) through
     ``Engine(..., ServeConfig(pack_weights=True))``: prompt batch 4 x 128,
     then 32 greedy decode steps (K1's launches by body: wgmma at prefill,
     tc_stream for the prefill's LM head and at decode, nothing else; the
     load's K5 packs: 112 tma_copy, the LM head tma_stage). The
     first prefill's logits are compared with the same weights run through
     the plain versions on the card. The decode step is a captured CUDA
     graph (``repro_torch.serve.graphs``): the counted call's first step
     warms it up and captures it, every later step replays it, and the
     replays' launches (credited by the graph) are counted as eager ones.
     Then generate through the graphs and eagerly (``Engine._graphed =
     False``): greedy tokens bitwise equal and launches by body equal, else
     the run fails; each timed end to end (decode ms/step) and alone (an
     eager decode forward, a graph replay), with its device-busy share by
     torch.profiler (over eager steps, over replays) and the capture's ms.
     The prefill is a graph per prompt shape (the counted call's prefill
     is its eager warm-up, the next call captures): its logits and the
     caches it writes bitwise the eager prefill's, its ms as served and
     its replay's against the eager forward (CUDA events), the replay's
     busy share (torch.profiler) and kernel records held to its credit,
     its capture's ms (``prefill_graph_check``; likewise in 3, 3b, 3c, 5).
     Then a sampled decode (temperature 0.7): the decode graph's replays
     feeding the sampler's graph (Gumbel-argmax on the device, one graph
     per logits shape), its tokens bitwise the eager loop's, and its
     ms/step beside the greedy one's, in turns (``sampled_decode_check``).
  2b. Serve the same olmo-1b (phase 2's bf16 weights, packed again at
     load) through the serving stack: ``ContinuousScheduler`` (max_live 8,
     block_size 16, max_len 256, bf16 cache) over its paged KV pool, on 24
     requests from a seed (prompts of 16-128 tokens, budgets of 8-48 greedy
     tokens, all at t = 0): (i) unpressured (128 blocks), (ii) a pool of
     three quarters of (i)'s peak blocks, so that requests are preempted
     and resumed, (iii) (i) with ``batch_step`` armed at hits 1-3 so that
     bisection evicts exactly one row, (iv) (i) on the int8 pool. Each run
     must close conservation and drain the pool, launch K1 only (113 a
     forward: a prefill's projections on wgmma, every other launch on
     tc_stream), and (ii)'s tokens and (iii)'s survivors must equal (i)'s
     bit for bit; then (i) greedy again on the graphs (every prefill a
     replay) and (i) sampled at temperature 0.7, through the graphs and
     eagerly: its tokens/s beside the greedy pass's and the sampler's
     graphs (full width and width 1). Then one batched step at 8 live rows: each row bitwise
     the same row run with the others dead (the check), against the
     batch-1 decode (reported only), the step, gather and scatter timed,
     the device-busy share by torch.profiler; and the first 8 requests
     through the scheduler and through the batch-1 ``StreamFrontend``
     (tokens/s of each). The batched step is the scheduler's captured graph
     (gather and decode; the scatter outside): each of (i)-(iv) runs
     through it and eagerly, with the same tokens, statistics, lifecycle
     events and launches by body, else the run fails; the step at 8 rows
     is bitwise the eager step's and timed both ways. The engine's
     prefills (admissions, resumes) go through its prefill graphs in the
     graph runs and eagerly in the eager runs: each run prints the prefill
     graphs captured and replayed and the host ms a batched step with the
     prefills included. The batch-1 front end runs on the graphs (the
     prefill's and the width-1 decode graph, a slot's caches copied in and
     back each step, the copy timed) and eagerly: its streams bitwise
     equal, else the run fails, and the tokens/s of each.
  3. Serve mixtral-8x22b at its published widths (d_model 6144, 48 heads /
     8 KV heads x 128, d_ff 16384, 8 experts top-2, vocab 32768) with its
     depth cut to 4 of 56 layers — the only cut, forced by memory (4
     layers of f32 weights are 40 GB, plus 20 GB packed in bf16) — the
     same way: prefill logits against the plain versions, expert choices
     compared, K1's launches by body as for olmo-1b, K2's on wgmma at
     prefill and tc_stream at decode, nothing else; the load's K5 packs
     on tma_copy, but the LM head's (table.t()) on tma_stage. The decode
     graph against the eager loop as in phase 2 (likewise in 3b, 3c, 5).
  3b. Serve olmo-1b with phase 2's weights quantized at load, as int8
     (tile scales) and as int4 (col scales), through
     ``ServeConfig(pack_weights=True, quantize=...)``: every K1 launch on
     wgmma_q (prefill) or tc_stream_q, nothing on the earlier quantized bodies; prefill
     logits against the plain versions on the same quantized weights (the
     gate, as phase 2's) and against phase 2's float logits (reported).
  3c. Serve mixtral-8x22b (4 of 56 layers, phase 3's seed, drawn again
     after phase 3's engine is freed) quantized to int8 the same way: K1
     and K2 on the quantized TMA bodies only, phase 3's logits gate, the
     error against phase 3's float logits reported.
  4. The paper's strategy comparison: square GEMMs of the paper's sizes
     (16 ... 4096) in f32 and bf16 through
     ``repro_torch.core.gemm.matmul(..., strategy=s)`` for every strategy
     and ``auto`` (naive and pluto up to 512, intrinsic up to 2048), each
     output against the f32 product (from 256 up, tiling must take K7's
     wgmma in bf16, tiling_packing K6's V_WGMMA, tiling_packing_fused K1's
     wgmma, vsx K8's fma_tiled; at f32 K1 runs on fma_tiled / fma_stream
     at every size; intrinsic takes K7's tc_stream / wgmma as one block);
     then the grouped lowerings on raw
     expert stacks (a bf16 silu-gate pair, E=8, with and without counts).
  5. Serve olmo-1b again with phase 2's weights RAW (bf16) through the
     default ``Engine(model, params)``: prefill logits against phase 2's,
     and the lowering of every contraction recorded (K1 at prefill on
     wgmma only, every K7 launch on tc_stream, the prefill's 112 K5
     packs on tma_copy); a profile of the prefill forward (device busy
     time, K5's device time a forward).
  6. Long-context attention through ``repro_torch.kernels.ops.attention``
     (K4) in bf16 at full head width, lengths from ``configs.shapes``:
     olmo-1b (16 heads x 128) at its served prefill and decode (A1, A2),
     prefill_32k (A3, batch 1 of 32) and decode_32k (A4, batch 128);
     mixtral-8x22b (48 / 8 heads x 128, window 4096) at prefill_32k (A5)
     and decode_32k (A6). One counted call a shape (exactly one K4 launch,
     on wgmma at A1 / A3 / A5 and stream at A2 / A4 / A6),
     checked against the plain version (each element within 2e-2 of |want|
     + its row's RMS, at most |want| + 1e-2, the norm within 1e-2, and a uniform-weight probe that
     catches one key too many or too few), timed (CUDA events; device
     time by CUDA events with the stream held back by a spin kernel, since
     late in the process torch.profiler loses kernel records; the
     profiler's mean kernel time beside it where it kept every record) beside its bound, the
     plain version and F.scaled_dot_product_attention (the yardstick only).
     Then served attention alone: ``models.layers.chunked_attention`` (what
     the served models run) at olmo-1b's served prefill and decode and one
     prefill_32k sequence, timed.
  7. Serve the other eight configs of the registry, one after another, each
     freed before the next, at their published widths through
     ``Engine(..., ServeConfig(pack_weights=True))`` with random f32 weights
     from a seed packed in bf16 at load: qwen3-4b (qk-norm), phi3-mini
     (head_dim 96), llama4-scout (16 experts top-1, untied head; 4 of 48
     layers), command-r-plus (parallel block; 4 of 64 layers), mamba2-130m
     (SSM), hymba-1.5b (attention and SSM averaged, window 1024),
     paligemma-3b (256 patch embeddings as a bidirectional prefix) and
     whisper-base (1500 frame embeddings through the encoder, cross
     attention); depth is cut only where one card's memory forces it
     (FAMILY_DEPTH). Prompt 2 x 64 tokens, 8 greedy steps. Each model:
     the load's K5 launches, K1's (and llama4's K2's) launches by body
     equal to the counts derived from its config (family_counts), finite
     tokens, K1 on every distinct packed weight at the rows the path
     gives it (2, the prefill's, whisper's 3000 encoder rows) and
     llama4's K2 at its C 16 / 8 against the plain versions on the body
     each must take, prefill logits within 5e-2 of the plain versions on
     the same weights (llama4 as mixtral: routing pinned, and free), peak
     memory and the card's line, and its decode graph against the eager
     loop (tokens bitwise, launches by body). Then, in a fresh process
     (late in this one torch.profiler loses its records), each model's
     prefill ms and decode ms/step, eager and as a graph replay (CUDA
     events), and their device busy time (torch.profiler); a family that
     ``serve.graphs.EAGER_FAMILIES`` names decodes eagerly, printed with
     its reason. In the main process each config's prefill graph (captured
     by the graph run) must give the eager prefill's logits and caches
     bitwise; in the timing process its call as served and its replay in
     CUDA events, the replay's busy share, its logits bitwise and its
     kernel records, held to the main process's credit. For phi3-mini,
     hymba-1.5b and whisper-base the timing process also traces the
     prefill's error against the plain versions stage by stage (each
     layer's residual stream, whisper's encoder output, the logits): the
     two paths run apart, and the error each stage adds on the plain
     path's input (``prefill_layer_errors``).
  8. Train full-width olmo-1b (16 layers, d_model 2048, vocab 50304, bf16
     compute over f32 masters, remat) through the launcher's entry point,
     ``repro_torch.launch.train.main`` (4 x 512 Markov tokens a step, 6
     steps), its step a captured CUDA graph (the first step its warm-up,
     the second its capture, the rest replays; its credit equal to the
     kernel records of a replay of the same step's graph in the timing
     process): every loss finite, step 6's below step 1's, and
     the launches by body (the warm-up's counted, the replays' credited)
     equal to the counts derived from the config
     (``train_step_counts``: K5 + K1 on wgmma for the forward, the
     recomputed layers and both products of the backward through
     ``core.autograd``, K7 only where the planner picks it, nothing
     else). Each distinct product of the step (forward, dX with W^T a
     view, dW) at its shape through ``gemm.matmul`` / ``weight_grad``
     against torch.matmul on the same bf16 inputs (2e-2 / 1e-3), on the
     bodies derived for it. (b) On one batch, the loss and every
     parameter's gradient through the kernels against the same step on
     ``torch_matmul`` (loss within 1e-2, each leaf within 5e-2 relative
     Frobenius error). (c) At 2 of 16 layers:
     2 steps, a checkpoint, 2 more; restored into fresh trees, the state
     bitwise the saved one and the same 2 steps bitwise the same losses.
     (d) At 2 of 16 layers: 4 graphed steps bitwise 4 eager steps from the
     same init and batches (metrics, params, moments, step). Then, in a
     fresh process, the eager step, the graphed step and the graphed step
     on ``torch_matmul``: each one's ms (host clock and CUDA events),
     tokens/s, peak memory, device busy share (torch.profiler), and the
     graph's capture ms and pool bytes.
  9. Guarded dispatch and the serving launcher, bf16. (a) No fault: a
     packed [2048, 8192] weight (olmo-1b's gate / up) at M 4 (K1
     tc_stream) and 512 (K1 wgmma), the same weight raw at M 4 (K7) and
     512 (K5 + K1), mixtral-8x22b's gate / up pair as packed expert
     stacks at C 8 with counts (K2): each auto output bitwise the named
     winner's, on those bodies, nothing degraded. (b) On the card the
     fallback chain is the winner alone: with ``kernel_compile`` or
     ``kernel_run`` armed at every hit, auto raises the injected fault
     with a note naming the spec and the winner, as the named winner
     does, and nothing is recorded; ``pack`` under the env override
     ``tiling_packing_fused`` on the raw weight raises the same way;
     ``scale_grid`` on an int8 packed weight under
     ``REPRO_NUMERICS_GUARD=1`` makes auto and the named
     ``packed_weight`` raise ``NumericsError`` naming the spec. What each
     spec ran and raised is printed. (c) ``kernel_run`` armed at its
     first hit during ``Engine.generate`` on full-width olmo-1b, packed,
     4 x 128 + 8 steps (the prefill graph's capture: its first call ran
     before the fault): the call raises in the prefill naming the spec,
     nothing is recorded, and the same engine's next call gives the
     tokens of a call before the fault; on a fresh engine, armed at the
     first hit past the prefill's, it raises at the decode graph's
     warm-up naming the spec, no graph is kept, and the next call
     warms up again, captures at its second step and gives those tokens. (d)
     ``launch.serve`` on the card with no device flag, full-width
     olmo-1b, 4 requests x 128 + 16 tokens: tokens/s and ms/decode-step
     beside the card's line; then ``launch.train.main`` at the tiny
     preset into a checkpoint and ``launch.serve`` serving it, whose
     greedy tokens must equal an Engine's on the restored params.
  10. The multi-device layer, in a process of its own (NCCL is never
     initialised in this one): ``launch.train.main`` at phase 8's widths
     for 3 steps with no process group, then under a one-rank NCCL group
     with ``--model-parallel 1`` (the sharding the identity, the tensors
     plain): losses bitwise, K1 / K5 launches by body as phase 8 derives
     them, the step a captured graph in both; then
     ``parallel.collectives.sp_decode_attention`` on that group at
     olmo-1b's decode width (B 4, H = Hkv = 16, D 128, S 2048), f32 and
     bf16, with a window and with invalid slots, against
     ``ref_decode_attention`` (1e-5 / 2e-2), both timed.
  11. The harness on the card, in a process of its own: a plan run
     through ``repro_torch.harness.run_plan`` on ``local-cuda`` (report
     under ``results/harness/<run-id>/``) that trains qwen3-4b,
     mamba2-130m, hymba-1.5b, paligemma-3b and whisper-base at published
     widths (depth cut only where 80 GB forces it: HARNESS_DEPTH, printed
     with why), bf16 compute over f32 masters, remat, 2 x 512 Markov tokens
     a step, 4 steps of ``make_train_step`` (the warm-up, the capture and
     its replay, two more replays): losses finite, launches only on K1 /
     K5 / K7, a replay's kernel records equal to its credit, qwen3-4b's
     launches equal to ``train_step_counts`` and its products held at
     shape as phase 8 holds olmo-1b's, the other four's distinct K1
     products re-run alone at their shapes against torch.matmul (2e-2 /
     1e-3); step ms (CUDA events), tokens/s and peak memory printed with
     the card's line. The
     same plan holds a probe with ``harness_job`` injected at its first
     attempt (retried once, completes), a job asking for twice the card's
     memory (fails as ``resource`` after 2 retries; the training after it
     completes) and an ``h100-pod`` job (a manifest: ``nvidia.com/gpu`` 8,
     parallelism 32). The report must read completed 6, failed 1, emitted
     1, retries 3, exit code 1, an empty health snapshot.
  12. The public GEMM surface, in a process of its own. (a) The grouped
     facades ``core.grouped_silu_gate`` + ``core.grouped_linear`` (the MoE
     gate/up pair, then the down projection) at mixtral-8x22b's expert
     widths (E 8, d_model 6144, d_ff 16384, bf16) on top-2 routing counts
     of 4 x 128 tokens from a seed (capacity 160 as the MoE layer computes
     it, expert 0 at count 0): packed stacks with counts (K2 only, on
     wgmma) and without (K3 only), raw stacks under
     ``grouped_packed_ragged`` (K5 + K2) and ``grouped_packed`` (K5 + K3),
     each output within 2e-2 / 1e-3 of the f32 oracle on the same inputs,
     rows past the counts exactly 0, each call timed (CUDA events) beside
     its bound on this run's counts. (b) ``core.LayeredGemm`` at olmo-1b's
     gate / up shape (M 4 and 512, K 2048, N 8192), f32 and bf16, one
     object per strategy and one with the planner's pick, each called 3
     times: one plan object throughout, within phase 4's tolerances of
     the f32 product, launches per strategy (K7; K5 + K6; K5 + K1; K8) and
     in bf16 on the bodies phase 1 holds at these shapes, each timed. Then
     the four example entry points as processes of their own on the card,
     started together: ``examples/torch_quickstart.py``,
     ``torch_serve_lm.py`` (batched, packed; and a continuous stream of 12
     requests), ``torch_train_lm.py --steps 4`` and
     ``torch_gemm_strategies.py --sizes 256,1024,4096``: each must exit 0
     with every printed error within its gate and the serving runs'
     health reports empty. The phase's seconds are printed.
  After every phase (and in phases 7 and 8's timing processes and phase
  11's and 12's processes) the guarded-dispatch health report must be empty: a
  contraction that degraded fails the run, named with its phase. Phase 9
  plants its own faults and clears what it planted. ``REPRO_FAULT=kernel_run:1`` in the
  environment fails the run where the first auto contraction runs (phase
  2): its traceback names the phase, the spec and the lowering.
With ``--planted-faults`` the script runs no phase: it builds copies of
K4's source with a fault planted in each (a KV tile dropped, the causal or
the window edge shifted by one key, the diagonal tile taken as interior,
the wgmma ring one KV tile short, warp 0's partial dropped from the stream
body's combine) and shows that phase 6's check fails each at every shape
it reaches and passes the kernel as built; then copies
of K8 with the last split-K chunk dropped, of K6 with its TMA ring one
k-step short, of K1 with A's tensor map lda wide instead of K and with
the last split dropped from tc_stream's reduction, and of K2 with a dead
segment that stores nothing, the row at the count kept, the pair's up
stream read from B's map and the last split dropped from grouped_reduce,
and of K7 with B's maps as wide as their row strides, the k-box count
floored and the last split dropped from tc_stream's reduction, and of K5
with its source map as wide as the row stride, the persistent walk's last
chunk dropped and the stage pass reading one lane over, and of K1 / K2's
quantized bodies (QUANT_FAULTS: the tile scale of the next k-tile, the col
scale applied to every split as well, int4's nibbles swapped, int4's -8
read as -7), which phase 1's K6 / K8, K1, K2 / K3, K7, K5 and quantized
checks must fail (K5 and the quantized ones: at every call each fault
reaches, the quantized ones at their edges and at the served shapes) while
passing the kernels as built. Every copy's nvcc starts at once.
``--planted-faults quantized`` runs the quantized copies alone.
  Each served or swept path runs with every kernel's launch count set to 0
  just before it and read just after; a path that did not launch what it
  must fails the run. Timings: for each served model, warm Engine.generate
  calls (decode ms/step and tokens/s end to end), the model's prefill and
  decode forwards alone, a profile of the decode forward; for each kernel
  shape its time beside its bound, its plain version and one PyTorch call;
  for the sweep each strategy's time per size.
With ``--served-attention PATH`` it runs no phase either: it times the
served models' ``chunked_attention`` from another copy of
``models/layers.py`` (for example a parent commit's) against this tree's,
in turns (other, this, this, other), at the shapes of phase 6's served
attention timing, on one card.
The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON summary.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.paper_gemm import (LARGE_SIZES,  # noqa: E402
                                            MEDIUM_SIZES, SMALL_SIZES,
                                            GemmProblem)
from repro_torch.roofline import hw  # noqa: E402

DEVICE = "cuda"
H100_BF16_FLOPS = hw.H100.peak_bf16_flops   # dense tensor-core peak, bf16
H100_HBM_BYTES = hw.H100.hbm_bw             # HBM3 bytes/s

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


# Each time a profiler reading was lost and stream-backed events stood in
# (``device_ms``, ``k5_times``): what, and why. Printed in the summary.
DEVICE_FALLBACKS = []


def device_ms(fn, reps: int, what: str = "") -> float:
    """Mean device time of ``fn(i)`` over ``reps`` calls: the kernels' own
    time from torch.profiler (CUPTI), without the host's launch gaps that
    CUDA events around a loop of small calls include. Where the profiler
    recorded no kernel time (its records were lost), the stream-backed
    events' time (``backed_ms``) instead, logged and listed in
    ``DEVICE_FALLBACKS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue  # a host op's device time is its kernels', counted here
        t = getattr(ev, "self_device_time_total", None)
        total += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
    if total <= 0:
        return backed_fallback(fn, reps, what, f"torch.profiler recorded no "
                               f"kernel time of {reps} calls")
    return total / reps / 1e3


def backed_fallback(fn, reps, what, why) -> float:
    """``backed_ms`` where a profiler reading was lost, logged and listed."""
    ms = backed_ms(fn, reps)
    DEVICE_FALLBACKS.append(dict(what=what or "a timed call", why=why, ms=ms))
    log(f"  device time of {what or 'a timed call'}: {why}; stream-backed "
        f"events instead, {ms:.4f} ms")
    return ms


def launch_ms(fn, reps: int) -> tuple:
    """Device time of ``fn(i)`` for a call that launches each of its
    kernels once, from torch.profiler: the mean duration of each kernel's
    launches, summed over the kernels. The profiler can lose kernel
    records late in this script's process, after the served phases' long
    profiles (on an H100: 2 of 5 at each phase-6 shape, then all of them,
    leaving only entries of zero time). Returns (ms, records kept of
    ``reps``, why not): ms is None when a kernel lost any record or no
    kernel time was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    total, kept = 0.0, None
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") or not ev.count:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
        if t <= 0:
            continue  # no kernel: an entry without device time
        total += t / ev.count
        kept = ev.count if kept is None else min(kept, ev.count)
    if kept is None:
        return None, 0, f"torch.profiler recorded no kernel time of {reps} calls"
    if kept < reps:
        return None, kept, f"torch.profiler kept {kept} of {reps} records"
    return total / 1e3, kept, None


def backed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` calls by CUDA events
    with the stream held back: a spin kernel (``torch.cuda._sleep``) runs
    while the host enqueues the calls, so they run back to back and the
    events time the device alone, without the host's launch gaps. Reads
    what torch.profiler reads within 0.5% at 1.4-1.8 ms kernels, and
    adds the device's gap between queued launches (about 2.6 us) to
    calls of a few microseconds."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.2, 2 * reps * host + 2e-3) * 2e9))
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timer_check(torch, label) -> dict:
    """torch.profiler (``launch_ms``) against stream-backed events
    (``backed_ms``) and plain events on one bf16 8192^3 torch.matmul, five
    calls each: phase 1 runs it in a fresh process, phase 6 after the
    served phases' long profiles, after which the profiler has lost
    kernel records."""
    a, b = (torch.randn((8192, 8192), device=DEVICE, dtype=torch.bfloat16)
            for _ in range(2))

    def call(i):
        return torch.matmul(a, b)
    prof, kept, lost = launch_ms(call, 5)
    out = dict(label=label, profiler_ms=prof, profiler_records=f"{kept}/5",
               profiler_lost=lost, backed_ms=backed_ms(call, 5),
               events_ms=time_ms(call, 5))
    log(f"  timer check ({label}), bf16 8192^3 matmul: stream-backed events "
        f"{out['backed_ms']:.4f} ms, events {out['events_ms']:.4f}, profiler "
        f"{fmt_ms(prof, lost)} ({kept}/5 records)")
    return out


def fmt_ms(ms, why_not) -> str:
    """A time for the log, or why there is none."""
    return f"{ms:.4f}" if ms is not None else f"none ({why_not})"


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


K1_EDGE_M = (1, 4, 15, 16, 17, 37, 512)
K1_EDGE_K = (700, 750, 2048)


def k1_body(m):
    """K1's body for bf16 A against the planner's aligned bf16 tiles."""
    return "tc_stream" if m <= 16 else "wgmma"


def k1_checks(torch, ks, quiet=False) -> tuple:
    """K1 against its plain version at its new bodies' edges, each call
    also held to the body it must take: A as a strided view whose columns
    past K hold NaN (the tensor map must be K wide), K 700 / 750 / 2048
    (tails whose last 64-deep box is padding), M 1 ... 512 (both sides of
    16), N = 200, both B layouts with bk 64 and 128; every epilogue with
    bias, c, alpha and beta at M=4 (K split) and M=512; N = 8192 and the
    LM head's 50304 at M 4 and 512 (blocks that walk several tiles); a
    misaligned A on mma_general; f32 and int8 on the CUDA-core bodies.
    bf16 output 2e-2 / 1e-3 (f32 sums in other orders, one bf16
    rounding), f32 1e-4, int8 exact. Returns (failed tags, launches by
    body over the checks)."""
    pk, gp, tf = ks["pack"], ks["gp"], ks["tf"]
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32
    fn = gp.gemm_packed_fused_a
    fails, seen = [], dict.fromkeys(fn.variants, 0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * std

    def a_view(m, k, dtype=bf16, nan_pad=True):
        """[m, k] view of a buffer with row stride a multiple of 8 whose
        columns past k hold NaN."""
        buf = torch.full((m, -(-k // 8) * 8 + 8), math.nan if nan_pad else 0.0,
                         device=DEVICE)
        buf[:, :k] = randn(m, k)
        return buf.to(dtype)[:, :k]

    def check(tag, body, a, bp, n, fmt, rtol, atol, **kw):
        before = dict(fn.variants)
        try:
            got = fn(a, bp, n, b_format=fmt, **kw)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            return
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        for v in ran:
            seen[v] += fn.variants[v] - before[v]
        ok, err = close(got, gp.gemm_packed_fused_a_plain(a, bp, n, b_format=fmt,
                                                          **kw), rtol, atol)
        ok = ok and ran == [body]
        if not ok:
            fails.append(tag)
        if not ok or not quiet:
            log(f"  check {tag} [{'+'.join(ran)}; want {body}]: max_abs_err="
                f"{err:.3e} (rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}")

    n = EDGE_N
    for k in K1_EDGE_K:
        w = randn(k, n, std=0.05).to(bf16)
        packs = {(bk, lay): (tf.TileFormat(bk=bk, bn=64, layout=lay, dtype="bfloat16"),
                             pk.pack_b_plain(w, bk, 64, lay))
                 for bk in (64, 128) for lay in ("row", "col")}
        for m in K1_EDGE_M:
            a = a_view(m, k)
            for (bk, lay), (fmt, bp) in packs.items():
                check(f"K1 bf16 NaN-padded A M={m} K={k} N={n} bk {bk} {lay}",
                      k1_body(m), a, bp, n, fmt, 2e-2, 1e-3)
    fmt = tf.TileFormat(bk=128, bn=64, dtype="bfloat16")
    for nn in (2048, 8192, 50304):
        bp = pk.pack_b_plain(randn(2048, nn, std=0.02).to(bf16), 128, 64, "row")
        for m in (4, 512):
            a = a_view(m, 2048)
            if nn == 2048:
                c, bias = randn(m, nn), randn(nn)
                for epi in EPIS:
                    check(f"K1 bf16 M={m} K=2048 N={nn} {epi}+bias, c, alpha, beta",
                          k1_body(m), a, bp, nn, fmt, 2e-2, 1e-3, c=c, alpha=1.5,
                          beta=0.5, bias=bias, epilogue=epi)
            else:
                check(f"K1 bf16 M={m} K=2048 N={nn}", k1_body(m), a, bp, nn, fmt,
                      2e-2, 1e-3)
    k, w = 300, randn(300, n, std=0.05)
    bp = pk.pack_b_plain(w.to(bf16), 128, 64, "row")
    for m in (4, 37):
        check(f"K1 bf16 A offset 5 (misaligned) M={m}", "mma_general",
              randn(m, k + 20).to(bf16)[:, 5:k + 5], bp, n, fmt, 2e-2, 1e-3,
              epilogue="gelu")
    fmt32 = tf.TileFormat(bk=64, bn=64, layout="col")
    bp32 = pk.pack_b_plain(randn(750, n, std=0.05), 64, 64, "col")
    fmt8 = tf.TileFormat(bk=64, bn=64, dtype="int8")
    wi = torch.randint(-100, 100, (750, n), generator=gen, device=DEVICE,
                       dtype=torch.int8)
    bp8 = pk.pack_b_plain(wi, 64, 64, "row")
    for m in K1_EDGE_M:
        body = "fma_stream" if m <= 16 else "fma_tiled"
        check(f"K1 f32 M={m} K=750 strided A col silu", body,
              a_view(m, 750, f32, nan_pad=False), bp32, n, fmt32, 1e-4, 1e-4,
              epilogue="silu")
        ai = torch.randint(-100, 100, (m, 758), generator=gen, device=DEVICE,
                           dtype=torch.int8)[:, :750]
        check(f"K1 int8 M={m} K=750 -> int32 (exact)", body, ai, bp8, n, fmt8,
              0.0, 0.0, out_dtype=torch.int32)
    return fails, seen


def phase_kernels(torch, gp, ref, tf, pk):
    """Kernel vs plain version on the card; returns (the per-shape table,
    the max abs error at the serving shapes)."""
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
            before = dict(gp.gemm_packed_fused_a.variants)
            for epi in (("none", "silu") if (k, n) == (2048, 8192)
                        else ("none",)):
                main_err = max(main_err, check(
                    f"bf16 M={m} K={k} N={n} {epi}", a, bps[0], n, fmt,
                    2e-2, 1e-3, bm=bm, epilogue=epi))
            ran = [v for v, c in gp.gemm_packed_fused_a.variants.items()
                   if c != before[v]]
            log(f"  body at M={m} K={k} N={n}: {ran} (want {[k1_body(m)]})")
            if ran != [k1_body(m)]:
                fails.append(f"body at M={m} K={k} N={n}")
            # Round-robin over `copies` packed weights (>= 128 MB in all) so
            # that B comes from HBM, not from the 50 MB L2, as in serving.
            reps = 20 if m == 4 else 5
            t_k = time_ms(lambda i: gp.gemm_packed_fused_a(
                a, bps[i % copies], n, bm=bm, b_format=fmt), reps)
            t_dev = device_ms(lambda i: gp.gemm_packed_fused_a(
                a, bps[i % copies], n, bm=bm, b_format=fmt), reps)
            t_p = time_ms(lambda i: gp.gemm_packed_fused_a_plain(
                a, bps[i % copies], n, bm=bm, b_format=fmt), max(2, reps // 4))
            t_l = time_ms(lambda i: torch.matmul(a, b_nat[i % copies]), reps)
            t_l_dev = device_ms(lambda i: torch.matmul(a, b_nat[i % copies]),
                                reps)
            b_bytes = fmt.packed_bytes(k, n)
            t_b, by = bound_ms(m, k, n, 2, b_bytes, 2, H100_BF16_FLOPS)
            table.append(dict(m=m, k=k, n=n, variant=ran[0] if ran else None,
                              ms=t_k, device_ms=t_dev, plain_ms=t_p,
                              library_ms=t_l, library_device_ms=t_l_dev,
                              bound_ms=t_b, bound_by=by))
            log(f"  time M={m} K={k} N={n}: kernel {t_k:.4f} ms (device "
                f"{t_dev:.4f}; {ran}), plain {t_p:.4f} ms, torch.matmul "
                f"{t_l:.4f} ms (device {t_l_dev:.4f}), bound {t_b:.4f} ms "
                f"({by})")
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
    edge_fails, edge_seen = k1_checks(torch, dict(pack=pk, gp=gp, tf=tf))
    log(f"  K1 edge checks, launches by body: {edge_seen}")
    fails += edge_fails
    if fails:
        raise AssertionError(f"kernel disagrees with its plain version: {fails}")
    return table, main_err


# The quantized TMA bodies (gemm_quant.cuh) at their edges: rows on both
# sides of the decode body's 16 and across the prefill body's 128-row
# tiles; K 700 with bk 64 (11 k-tiles, the last box partly padding).
KQ_EDGE_ROWS = (1, 4, 16, 17, 160, 512)
KQ_FORMATS = [(qd, gran, lay) for qd in ("int8", "int4")
              for gran in ("tile", "col") for lay in ("row", "col")]


def kq_body(rows):
    """The quantized TMA body for bf16 / f16 A against aligned int tiles."""
    return "tc_stream_q" if rows <= 16 else "wgmma_q"


def kq_full_range(torch, gen, shape, qd):
    """int8 values over the whole range of ``qd`` (int4: -8 ... 7, int8:
    -128 ... 127), the extremes included: the quantizer clips to +-7 /
    +-127, so only tiles drawn like this hold -8 and -128."""
    lo, hi = (-8, 8) if qd == "int4" else (-128, 128)
    return torch.randint(lo, hi, shape, generator=gen, device=DEVICE,
                         dtype=torch.int8)


class KqJudge:
    """Holds quantized K1 / K2 / K3 calls to their plain versions and to the
    body the route names, for kq_checks and kq_served. A freed NaN block of
    the output's size lies where each output is allocated (an element the
    kernel does not store shows); rows past the counts must be exactly 0;
    2e-2 / 1e-3. ``reach`` gets each case's tag -> its attributes (kernel,
    int type, scale, k-tiles a column, splits, dtype, body) for the planted
    faults."""

    def __init__(self, torch, ks, quiet, reach):
        self.torch, self.ks, self.quiet = torch, ks, quiet
        self.reach = {} if reach is None else reach
        gg = ks["gg"]
        self.k2fn, self.k3fn = gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed
        fns = (ks["gp"].gemm_packed_fused_a, self.k2fn, self.k3fn)
        self.fails = []
        self.seen = {f.__name__: dict.fromkeys(f.variants, 0) for f in fns}
        self.worst = {}  # "wrapper body" -> the largest error of its passing cases

    def check(self, tag, fn, body, args, plain, out_shape, counts=None,
              attrs=None, **kw):
        torch = self.torch
        poison = torch.full(out_shape, math.nan, device=DEVICE,
                            dtype=kw.get("out_dtype") or args[0].dtype)
        del poison
        before = dict(fn.variants)
        self.reach[tag] = dict(attrs or {}, body=body)
        try:
            got = fn(*args, **kw)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            self.fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            return
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        for v in ran:
            self.seen[fn.__name__][v] += fn.variants[v] - before[v]
        ok, err = close(got, plain(*args, **kw), 2e-2, 1e-3)
        zeros = True
        if counts is not None:
            mask = self.ks["ref"].ragged_row_mask(
                args[0].shape[2], counts.clamp(0, args[0].shape[2]))
            zeros = not bool(got[~mask].any())
        ok = ok and zeros and ran == [body]
        if not ok:
            self.fails.append(tag)
        else:
            key = f"{fn.__name__} {body}"
            self.worst[key] = max(self.worst.get(key, 0.0), err)
        if not ok or not self.quiet:
            log(f"  check {tag} [{'+'.join(ran)}; want {body}]: max_abs_err="
                f"{err:.3e}{'' if counts is None else f', zeros past counts {zeros}'}"
                f" (rtol=2e-2, atol=1e-3) {'ok' if ok else 'FAIL'}")

    def k1(self, tag, body, a, bp, n, sc, fmt, **kw):
        gp = self.ks["gp"]
        m, k = a.shape
        kb = bp.shape[1]
        splits = (gp.tc_stream_split(kb, -(-n // 64))[0]
                  if body == "tc_stream_q" else 1)
        self.check(tag, gp.gemm_packed_fused_a, body, (a, bp, n),
                   gp.gemm_packed_fused_a_plain, (m, n),
                   attrs=dict(kernel="K1", qd=fmt.dtype, gran=fmt.scale and
                              fmt.scale.granularity, kb=kb, splits=splits,
                              dtype=str(a.dtype)), b_scales=sc, b_format=fmt, **kw)

    def k2(self, tag, body, a, bp, n, counts, sc, fmt, b2p=None, sc2=None,
           live=True, **kw):
        gp, gg = self.ks["gp"], self.ks["gg"]
        e, s, c, k = a.shape
        kb = bp.shape[2]
        splits = (gp.tc_stream_split(kb, e * s * -(-n // 64))[0]
                  if body == "tc_stream_q" else 1)
        attrs = dict(kernel="K2", qd=fmt.dtype, gran=fmt.scale and
                     fmt.scale.granularity, kb=kb, splits=splits,
                     dtype=str(a.dtype), live=live)
        kw.update(b2_packed=b2p, b_scales=sc, b2_scales=sc2, b_format=fmt)
        if counts is None:
            self.check(tag, self.k3fn, body, (a[:, 0], bp, n),
                       gg.gemm_grouped_packed_plain, (e, c, n), attrs=attrs, **kw)
        else:
            self.check(tag, self.k2fn, body, (a, bp, n, counts),
                       gg.gemm_grouped_packed_ragged_plain, (e, s, c, n),
                       counts=counts, attrs=attrs, **kw)

    def result(self) -> tuple:
        self.seen["max_abs_err_by_body"] = self.worst
        return self.fails, self.seen


def kq_checks(torch, ks, quiet=False, reach=None) -> tuple:
    """Both quantized TMA bodies of K1 (tc_stream_q, wgmma_q) and of K2 / K3
    against their plain versions, each call held to the body the route
    names: int8 / int4 tiles over their whole range (-8 and -128 included)
    with random tile or col scales, row and col layouts; K1 at M 1 / 4 /
    16 / 17 / 160 / 512, K 700 (bk 64: 11 k-tiles, split at decode) and an
    unsplit decode (N 17000: 266 stripes), gelu + bias, every epilogue with
    bias, c, alpha and beta at M 4 and 512, f16, unscaled int8 tiles, and a
    misaligned A on the earlier mma_quant; K2 at C 1 / 8 / 16 / 17 / 160 / 300
    over counts 0, partial, C, > C and negative (E 3, S 2), the pair with B
    != B2 and their own scales, gelu + bias, an unsplit decode (E 8, S 2,
    N 2048), every segment dead, K3, and a misaligned A on the earlier
    mma_sync. A freed NaN block of the output's size lies where each output
    is allocated (an element the kernel does not store shows); rows past
    the counts must be exactly 0. bf16 / f16 output 2e-2 / 1e-3 (f32 sums
    in other orders, one rounding). ``reach``, when given, gets each case's
    tag -> its attributes (kernel, int type, scale, k-tiles a column,
    splits, body) for the planted faults. Returns (failed tags, launches by
    body of each wrapper)."""
    ref, tf = ks["ref"], ks["tf"]
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    bf16 = torch.bfloat16
    judge = KqJudge(torch, ks, quiet, reach)
    k1_check, k2_check = judge.k1, judge.k2

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * std

    def fmt_of(qd, gran, lay, bk):
        scale = dict(scale=tf.ScaleSpec(granularity=gran)) if gran else {}
        return tf.TileFormat(bk=bk, bn=64, layout=lay, dtype=qd, **scale)

    def scales_of(lead, nb, kb, gran):
        shape = lead + ((nb,) if gran == "col" else (nb, kb))
        return torch.rand(shape, generator=gen, device=DEVICE) * 1e-2 + 1e-3

    def k1_operands(k, n, qd, gran, lay, bk=64):
        q = kq_full_range(torch, gen, (k, n), qd)
        bp = ref.pack_b_ref(q, tf.TileFormat(bk=bk, bn=64, layout=lay, dtype=qd))
        sc = scales_of((), *bp.shape[:2], gran) if gran else None
        return bp, sc, fmt_of(qd, gran, lay, bk)

    def k2_operands(e, k, n, qd, gran, lay, bk=64):
        q = kq_full_range(torch, gen, (e, k, n), qd)
        bp = ref.pack_b_grouped_ref(q, tf.TileFormat(bk=bk, bn=64, layout=lay,
                                                     dtype=qd))
        sc = scales_of((e,), *bp.shape[1:3], gran) if gran else None
        return bp, sc, fmt_of(qd, gran, lay, bk)

    def a_view(*shape, dtype=bf16, offset=0):
        """[..., K] view, row stride a multiple of 8, NaN past K."""
        k = shape[-1]
        buf = torch.full(shape[:-1] + (-(-k // 8) * 8 + 8 + offset,), math.nan,
                         device=DEVICE)
        buf[..., offset:offset + k] = randn(*shape)
        return buf.to(dtype)[..., offset:offset + k]

    # -- K1 ----------------------------------------------------------------
    k, n = 700, 200
    bias = randn(n)
    for qd, gran, lay in KQ_FORMATS:
        bp, sc, fmt = k1_operands(k, n, qd, gran, lay)
        for m in KQ_EDGE_ROWS:
            k1_check(f"K1 {qd}:{gran} {lay} M={m} K={k} N={n} gelu+bias",
                     kq_body(m), a_view(m, k), bp, n, sc, fmt, epilogue="gelu",
                     bias=bias)
        bp, sc, fmt = k1_operands(k, 17000, qd, gran, lay)
        k1_check(f"K1 {qd}:{gran} {lay} M=4 K={k} N=17000 (unsplit)",
                 "tc_stream_q", a_view(4, k), bp, 17000, sc, fmt)
    bp, sc, fmt = k1_operands(2048, 2048, "int8", "col", "row", bk=128)
    c_in, bias2 = randn(512, 2048), randn(2048)
    for m in (4, 512):
        for epi in EPIS:
            k1_check(f"K1 int8:col M={m} K=2048 N=2048 {epi}+bias, c, alpha, "
                     f"beta", kq_body(m), a_view(m, 2048), bp, 2048, sc, fmt,
                     c=c_in[:m], alpha=1.5, beta=0.5, bias=bias2, epilogue=epi)
    for qd, gran in (("int4", "tile"), ("int8", None)):
        bp, sc, fmt = k1_operands(2048, 256, qd, gran, "row", bk=128)
        for m in (4, 200):
            k1_check(f"K1 {qd}:{gran} f16 M={m} K=2048 N=256", kq_body(m),
                     a_view(m, 2048, dtype=torch.float16), bp, 256, sc, fmt)
    bp, sc, fmt = k1_operands(300, n, "int8", "tile", "row", bk=128)
    for m in (4, 37):
        k1_check(f"K1 int8:tile A offset 5 (misaligned) M={m}", "mma_quant",
                 a_view(m, 300, offset=5), bp, n, sc, fmt, epilogue="silu")

    # -- K2 / K3 ---------------------------------------------------------------
    e, s = 3, 2
    gbias = randn(e, n)
    for qd, gran, lay in KQ_FORMATS:
        (bp, sc, fmt), (b2p, sc2, _) = (k2_operands(e, k, n, qd, gran, lay),
                                        k2_operands(e, k, n, qd, gran, lay))
        for c in K2_EDGE_C:
            counts = torch.tensor([[0, c], [c // 2, 1], [c + 7, -2]],
                                  dtype=torch.int32, device=DEVICE)
            a = a_view(e, s, c, k)
            k2_check(f"K2 {qd}:{gran} {lay} pair C={c} K={k} N={n}", kq_body(c),
                     a, bp, n, counts, sc, fmt, b2p, sc2, epilogue="silu_gate")
            if c in (8, 160):
                k2_check(f"K2 {qd}:{gran} {lay} gelu+bias C={c}", kq_body(c),
                         a, bp, n, counts, sc, fmt, epilogue="gelu", bias=gbias)
                k2_check(f"K3 {qd}:{gran} {lay} pair M={c}", kq_body(c),
                         a_view(e, 1, c, k), bp, n, None, sc, fmt, b2p, sc2,
                         epilogue="silu_gate")
    for qd, gran in (("int8", "tile"), ("int4", "col")):
        (bp, sc, fmt), (b2p, sc2, _) = (k2_operands(8, 2048, 2048, qd, gran,
                                                    "row", bk=128),
                                        k2_operands(8, 2048, 2048, qd, gran,
                                                    "row", bk=128))
        counts8 = torch.tensor([[2, 0], [8, 1], [0, 0], [3, 5], [8, 8], [0, 1],
                                [4, 0], [1, 2]], dtype=torch.int32, device=DEVICE)
        k2_check(f"K2 {qd}:{gran} pair unsplit E=8 S=2 C=8 K=2048 N=2048",
                 "tc_stream_q", a_view(8, 2, 8, 2048), bp, 2048, counts8, sc,
                 fmt, b2p, sc2, epilogue="silu_gate")
        for c in (8, 160):
            dead = torch.zeros((8, 2), dtype=torch.int32, device=DEVICE)
            k2_check(f"K2 {qd}:{gran} pair every segment dead C={c}", kq_body(c),
                     a_view(8, 2, c, 2048), bp, 2048, dead, sc, fmt, b2p, sc2,
                     live=False, epilogue="silu_gate")
    bp, sc, fmt = k2_operands(e, 300, n, "int8", "tile", "row", bk=128)
    for c in (8, 40):
        counts = torch.tensor([[0, c], [c // 2, 1], [c + 7, -2]],
                              dtype=torch.int32, device=DEVICE)
        k2_check(f"K2 int8:tile A offset 5 (misaligned) C={c}", "mma_sync",
                 a_view(e, s, c, 300, offset=5), bp, n, counts, sc, fmt,
                 epilogue="gelu", bias=gbias)
    return judge.result()


def kq_library(torch, a, q_nat, scales_kn, qd, gran, bk):
    """The one-call yardstick for K1's quantized bodies, where the card's
    torch has it: ``torch._weight_int8pack_mm`` (int8 weights [N, K], one
    scale a column) for int8 tiles with col scales, ``torch._weight_int4pack_mm``
    (tinygemm: uint4 = q + 8, zero 0, one bf16 scale a (k-group of bk,
    column)) for int4. Returns (call, its description) or (None, why not);
    the layout conversion happens here, outside any timing."""
    n = q_nat.shape[1]
    try:
        if qd == "int8" and gran == "col":
            w = q_nat.t().contiguous()
            sc = scales_kn[0].to(a.dtype).contiguous()
            fn = torch._weight_int8pack_mm
            fn(a, w, sc)
            return (lambda: fn(a, w, sc)), "torch._weight_int8pack_mm"
        if qd == "int4":
            u = (q_nat.t().to(torch.int32) + 8)          # [N, K] in 0 ... 15
            packed = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
            w = torch._convert_weight_to_int4pack(packed.contiguous(), 8)
            kg = q_nat.shape[0] // bk
            sz = torch.zeros((kg, n, 2), dtype=torch.bfloat16, device=a.device)
            sz[..., 0] = scales_kn.reshape(kg, bk, n)[:, 0].to(torch.bfloat16)
            fn = torch._weight_int4pack_mm
            fn(a, w, bk, sz)
            return (lambda: fn(a, w, bk, sz)), (
                f"torch._weight_int4pack_mm (group {bk}, bf16 scales)")
    except Exception as exc:  # the op is absent or refuses these operands
        return None, f"none on this card's torch ({type(exc).__name__}: {exc})"[:200]
    return None, "none: no single PyTorch call for int8 tiles with tile scales"


def forced_route(mod, attr, body):
    """A context in which ``mod.attr`` (a route function) names ``body``
    for every call: how the earlier bodies are reached at shapes the route
    sends to the new ones."""
    real = getattr(mod, attr)

    class Forced:
        def __enter__(self):
            setattr(mod, attr, lambda *a, **k: body)

        def __exit__(self, *exc):
            setattr(mod, attr, real)
    return Forced()


KQ_OLD = {"K1": "mma_quant", "K2": "mma_sync"}  # the earlier quantized bodies
# The served quantized formats: the planner's bk 128, bn 64, row tiles.
KQ_SERVED = (("int8", "tile"), ("int4", "col"))


def kq_envelopes(torch) -> dict:
    """mixtral-8x22b's expert envelopes, (C, counts [E]): decode (4 tokens
    routed top-2 over uniform experts) and prefill (512 tokens, skewed)."""
    cpu_gen = torch.Generator().manual_seed(3)
    return {"decode": (8, route_counts(torch, cpu_gen, 4, [1.0] * MIX_E, 8)),
            "prefill": (160, route_counts(torch, cpu_gen, 512,
                                          [0, 3, 2.5, 1, 2, 0.4, 1, 2], 160))}


def kq_served(torch, ks, quiet=False, reach=None) -> tuple:
    """K1's and K2 / K3's quantized bodies held to their plain versions at
    the shapes the served paths give them (kq_times' shapes): K1 at
    olmo-1b's four (K, N) at M 4 and 512 (the LM head at M 4 only), K2 and
    K3 at mixtral-8x22b's gate/up pair (B != B2, silu gate) and down at the
    decode (C 8) and prefill (C 160) envelopes; int8 tiles with tile scales
    and int4 tiles with col scales (bk 128, bn 64, row); the new body and
    the earlier one (forced through the route). The tiles hold the whole
    int range (-8 and -128 included) and each scale is drawn over a 16x
    range around a size that keeps outputs near 1: the quantizer's scales
    at random init are nearly uniform, and a scale taken from the wrong
    tile or applied twice would hide in them. KqJudge's tolerance and zero
    check. Returns (failed tags, launches by body)."""
    gp, ref, tf = ks["gp"], ks["ref"], ks["tf"]
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    judge = KqJudge(torch, ks, quiet, reach)
    bf16 = torch.bfloat16

    def operands(lead, k, n, qd, gran):
        q = kq_full_range(torch, gen, lead + (k, n), qd)
        pack = ref.pack_b_grouped_ref if lead else ref.pack_b_ref
        bp = pack(q, tf.TileFormat(bk=128, bn=64, dtype=qd))
        del q
        nb, kb = bp.shape[len(lead):len(lead) + 2]
        size = 2.0 / (math.sqrt(k) * (74.0 if qd == "int8" else 4.6))
        shape = lead + ((nb,) if gran == "col" else (nb, kb))
        sc = size * torch.exp2(torch.rand(shape, generator=gen, device=DEVICE)
                               * 4 - 2)
        return bp, sc, tf.TileFormat(bk=128, bn=64, dtype=qd,
                                     scale=tf.ScaleSpec(granularity=gran))

    for qd, gran in KQ_SERVED:
        for (k, n), cnt in OLMO_SHAPES.items():
            bp, sc, fmt = operands((), k, n, qd, gran)
            for m in (4, 512):
                if m == 512 and cnt is None:
                    continue  # the LM head runs at the last positions only
                a = torch.randn((m, k), generator=gen, device=DEVICE).to(bf16)
                tag = f"K1 {qd}:{gran} served M={m} K={k} N={n}"
                judge.k1(tag, kq_body(m), a, bp, n, sc, fmt)
                with forced_route(gp, "fused_a_body", KQ_OLD["K1"]):
                    judge.k1(f"{tag} (earlier body)", KQ_OLD["K1"], a, bp, n, sc,
                             fmt)
            del bp, sc
        for name, k, n, pair in (("gate_up", MIX_D, MIX_F, True),
                                 ("down", MIX_F, MIX_D, False)):
            (bp, sc, fmt), (b2p, sc2, _) = (
                operands((MIX_E,), k, n, qd, gran),
                operands((MIX_E,), k, n, qd, gran) if pair else (None, None, None))
            epi = "silu_gate" if pair else "none"
            for env, (c, counts_h) in kq_envelopes(torch).items():
                counts = counts_h.reshape(MIX_E, 1).to(DEVICE)
                a = torch.randn((MIX_E, 1, c, k), generator=gen,
                                device=DEVICE).to(bf16)
                for body, forced in ((kq_body(c), None), (KQ_OLD["K2"], KQ_OLD["K2"])):
                    tail = "" if forced is None else " (earlier body)"
                    ctx = (forced_route(ks["gg"], "grouped_body", forced)
                           if forced else contextlib.nullcontext())
                    with ctx:
                        judge.k2(f"K2 {qd}:{gran} served {name} {env} C={c}{tail}",
                                 body, a, bp, n, counts, sc, fmt, b2p, sc2,
                                 epilogue=epi)
                        judge.k2(f"K3 {qd}:{gran} served {name} {env} C={c}{tail}",
                                 body, a, bp, n, None, sc, fmt, b2p, sc2,
                                 epilogue=epi)
                del a
            del bp, b2p, sc, sc2
            torch.cuda.empty_cache()
    return judge.result()


def kq_times(torch, ks) -> dict:
    """K1's and K2 / K3's quantized bodies timed where the served paths run
    them: K1 at olmo-1b's shapes at decode (M 4, 113 calls a forward) and
    prefill (M 512, the 112 projections), int8 tiles with tile scales and
    int4 tiles with col scales (bk 128, bn 64, row, the planner's); K2 and
    K3 at mixtral-8x22b's expert shapes at the decode (C 8) and prefill (C
    160) envelopes. Each shape: the new body and the old one (the earlier
    mma_quant / mma_sync, forced through the route for the call) in
    device time (torch.profiler) and CUDA events, the plain version, the
    bound on the narrow tiles' bytes (and scales), and the one-call library
    yardstick where the card's torch has one. Weights round-robin over
    copies of at least 128 MB so that they come from HBM."""
    gp, gg, ref, tf = ks["gp"], ks["gg"], ks["ref"], ks["tf"]
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    layers = 16  # olmo-1b
    out = {}
    for qd, gran in KQ_SERVED:
        qf = tf.TileFormat(bk=128, bn=64, dtype=qd,
                           scale=tf.ScaleSpec(granularity=gran))
        rows = []
        for (k, n), cnt in OLMO_SHAPES.items():
            w = torch.randn((k, n), generator=gen, device=DEVICE) * 0.02
            q, s = ref.pack_b_ref(w, qf)
            nbytes = q.numel() * q.element_size() + s.numel() * 4
            copies = max(1, min(16, math.ceil(128e6 / nbytes)))
            packs = [(q, s)] + [ref.pack_b_ref(torch.randn(
                (k, n), generator=gen, device=DEVICE) * 0.02, qf)
                for _ in range(copies - 1)]
            q_nat = ref.unpack_b_ref(q, k, n, fmt=qf)
            sc_kn = (s.repeat_interleave(64)[:n].expand(k, n) if gran == "col"
                     else s.repeat_interleave(64, 0).repeat_interleave(128, 1)
                     .t()[:k, :n])
            for m in (4, 512):
                if m == 512 and cnt is None:
                    continue  # the LM head runs at the last positions only
                a = torch.randn((m, k), generator=gen, device=DEVICE).to(torch.bfloat16)

                def call(i, a=a, n=n):
                    qq, ss = packs[i % copies]
                    gp.gemm_packed_fused_a(a, qq, n, b_scales=ss, b_format=qf)
                before = dict(gp.gemm_packed_fused_a.variants)
                call(0)
                ran = [v for v, c in gp.gemm_packed_fused_a.variants.items()
                       if c != before[v]]
                if ran != [kq_body(m)]:
                    raise AssertionError(f"K1 {qd}:{gran} M={m} K={k} N={n} "
                                         f"took {ran}, not {kq_body(m)}")
                reps = 10 if m == 4 else 4
                row = dict(m=m, k=k, n=n, calls=(cnt or 1) * layers if cnt else 1,
                           body=kq_body(m), ms=time_ms(call, reps),
                           device_ms=device_ms(call, reps),
                           plain_ms=time_ms(lambda i: gp.gemm_packed_fused_a_plain(
                               a, q, n, b_scales=s, b_format=qf), 2))
                with forced_route(gp, "fused_a_body", KQ_OLD["K1"]):
                    row["old_device_ms"] = device_ms(call, reps)
                    row["old_ms"] = time_ms(call, reps)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    m, k, n, 2, nbytes, 2, H100_BF16_FLOPS)
                lib, row["library"] = kq_library(torch, a, q_nat, sc_kn, qd, gran,
                                                 128)
                if lib is not None:
                    got = lib()
                    want = gp.gemm_packed_fused_a_plain(a, q, n, b_scales=s,
                                                        b_format=qf)
                    row["library_rel_err"] = float(
                        (got.float() - want.float()).norm() / want.float().norm())
                    row["library_ms"] = time_ms(lambda i: lib(), reps)
                    row["library_device_ms"] = device_ms(lambda i: lib(), reps)
                else:
                    row["library_ms"] = row["library_device_ms"] = None
                rows.append(row)
                log(f"  K1 {qd}:{gran} M={m} K={k} N={n}: {row['body']} device "
                    f"{row['device_ms']:.4f} ms (events {row['ms']:.4f}), old "
                    f"mma_quant device {row['old_device_ms']:.4f}, bound "
                    f"{row['bound_ms']:.4f} ({row['bound_by']}), plain "
                    f"{row['plain_ms']:.4f}; library {row['library']}"
                    + (f" device {row['library_device_ms']:.4f} (rel err "
                       f"{row['library_rel_err']:.2e})" if lib else ""))
            del packs
        for m, label in ((4, "decode"), (512, "prefill")):
            sel = [r for r in rows if r["m"] == m]
            fwd = {key: sum(r[key] * r["calls"] for r in sel)
                   for key in ("ms", "device_ms", "old_ms", "old_device_ms",
                               "plain_ms", "bound_ms")}
            libs = [r["library_device_ms"] for r in sel]
            fwd["library_device_ms"] = (None if None in libs else
                                        sum(r["library_device_ms"] * r["calls"]
                                            for r in sel))
            libs = [r["library_ms"] for r in sel]
            fwd["library_ms"] = (None if None in libs else
                                 sum(r["library_ms"] * r["calls"] for r in sel))
            fwd["library"] = sel[0]["library"]
            fwd["calls"] = sum(r["calls"] for r in sel)
            out[f"K1 {qd}:{gran} {label}"] = dict(fwd, shapes=sel,
                                                  body=kq_body(m))
            log(f"  K1 {qd}:{gran}, one olmo-1b {label} forward ({fwd['calls']} "
                f"calls, M={m}): {kq_body(m)} device {fwd['device_ms']:.4f} ms "
                f"(events {fwd['ms']:.4f}), old mma_quant device "
                f"{fwd['old_device_ms']:.4f}, bound {fwd['bound_ms']:.4f}, plain "
                f"{fwd['plain_ms']:.4f}, library device {fwd['library_device_ms']}")

    envelopes = kq_envelopes(torch)
    for qd, gran in KQ_SERVED:
        qf = tf.TileFormat(bk=128, bn=64, dtype=qd,
                           scale=tf.ScaleSpec(granularity=gran))
        for name, k, n, pair in (("gate_up", MIX_D, MIX_F, True),
                                 ("down", MIX_F, MIX_D, False)):
            stacks = [ref.pack_b_grouped_ref(torch.randn(
                (MIX_E, k, n), generator=gen, device=DEVICE) * 0.02, qf)
                for _ in range(2 if pair else 1)]
            (bp, sc), (b2p, sc2) = stacks[0], (stacks[-1] if pair else (None, None))
            kw = dict(b_format=qf, b_scales=sc, b2_packed=b2p, b2_scales=sc2,
                      epilogue="silu_gate" if pair else "none")
            b_bytes = bp[0].numel() + sc[0].numel() * 4
            for env, (c, counts_h) in envelopes.items():
                counts = counts_h.reshape(MIX_E, 1).to(DEVICE)
                a = torch.randn((MIX_E, 1, c, k), generator=gen,
                                device=DEVICE).to(torch.bfloat16)
                a3 = a.reshape(MIX_E, c, k)

                def k2_call(i):
                    gg.gemm_grouped_packed_ragged(a, bp, n, counts, **kw)

                def k3_call(i):
                    gg.gemm_grouped_packed(a3, bp, n, **kw)
                before = dict(gg.gemm_grouped_packed_ragged.variants)
                k2_call(0)
                ran = [v for v, x in gg.gemm_grouped_packed_ragged.variants.items()
                       if x != before[v]]
                if ran != [kq_body(c)]:
                    raise AssertionError(f"K2 {qd}:{gran} {name} C={c} took {ran}")
                reps = 5 if env == "decode" else 3
                row = dict(contraction=name, envelope=env, c=c, k=k, n=n,
                           counts=counts_h.tolist(), body=kq_body(c),
                           k2_ms=time_ms(k2_call, reps),
                           k2_device_ms=device_ms(k2_call, reps),
                           k3_ms=time_ms(k3_call, reps),
                           k3_device_ms=device_ms(k3_call, reps),
                           k2_plain_ms=time_ms(
                               lambda i: gg.gemm_grouped_packed_ragged_plain(
                                   a, bp, n, counts, **kw), 2))
                with forced_route(gg, "grouped_body", KQ_OLD["K2"]):
                    row["k2_old_device_ms"] = device_ms(k2_call, reps)
                    row["k3_old_device_ms"] = device_ms(k3_call, reps)
                row["k2_bound_ms"], row["k2_bound_by"] = grouped_bound_ms(
                    counts_h, MIX_E, c, k, n, b_bytes, pair)
                row["k3_bound_ms"], row["k3_bound_by"] = grouped_bound_ms(
                    None, MIX_E, c, k, n, b_bytes, pair)
                row["library_ms"] = None
                out.setdefault(f"K2 {qd}:{gran}", []).append(row)
                log(f"  K2 {qd}:{gran} {name} {env} C={c} ({row['body']}): device "
                    f"{row['k2_device_ms']:.4f} ms (events {row['k2_ms']:.4f}), old "
                    f"mma_sync device {row['k2_old_device_ms']:.4f}, bound "
                    f"{row['k2_bound_ms']:.4f} ({row['k2_bound_by']}), plain "
                    f"{row['k2_plain_ms']:.4f}; K3 device {row['k3_device_ms']:.4f} "
                    f"(old {row['k3_old_device_ms']:.4f}, bound "
                    f"{row['k3_bound_ms']:.4f})")
            del stacks, bp, b2p, kw
            torch.cuda.empty_cache()
    return out


def phase_quant_kernels(torch, ks) -> tuple:
    """Phase 1's quantized part: kq_checks (the edges), kq_served (the
    served shapes), then kq_times. Returns (the timings, the checks'
    launches by body)."""
    fails, seen = kq_checks(torch, ks, quiet=True)
    log(f"  quantized TMA bodies' edge checks: {len(fails)} failed; launches by "
        f"body {seen}")
    served_fails, served_seen = kq_served(torch, ks, quiet=True)
    log(f"  quantized bodies at the served shapes: {len(served_fails)} failed; "
        f"launches by body {served_seen}")
    fails += served_fails
    if fails:
        raise AssertionError(f"quantized kernels disagree with their plain "
                             f"versions: {fails}")
    worst = seen["max_abs_err_by_body"]
    for key, err in served_seen.pop("max_abs_err_by_body").items():
        worst[key] = max(worst.get(key, 0.0), err)
    seen["served_shapes"] = served_seen
    return kq_times(torch, ks), seen


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


# K2 / K3 edge shapes: segment envelopes on both sides of the decode body's
# 16 rows, inside the wgmma body's 256-row m-tile (one, three live 64-row
# boxes) and across two m-tiles; K 700, whose last 64-deep box is partly
# (bk 64) or wholly (bk 128) padding; N 200 and 136 (odd Nb).
K2_EDGE_C = (1, 8, 16, 17, 160, 300)


def k2_body(c):
    """K2 / K3's body for bf16 / f16 A against aligned tiles of its type
    (bn 64, bk a multiple of 64)."""
    return "tc_stream" if c <= 16 else "wgmma"


def k2_checks(torch, ks, quiet=False) -> tuple:
    """K2 and K3 against their plain versions at the TMA bodies' edges,
    each call also held to the body it must take. A is a view of a buffer
    whose columns past K hold NaN (A's map must be K wide); its rows
    between the count and C hold data (the kernel must not read them as
    padding). Segment envelopes C 1 / 8 / 16 / 17 / 160 / 300, counts 0,
    partial, C, > C and negative over E = 3, S = 2; K = 700 with bk 64 and
    128, both layouts; the silu-gate pair with B != B2 and bias; every
    epilogue with bias, split (C = 8: 24 stripes split K) and not; f16;
    S = 2 with A permuted (sa_e < sa_s); one live segment with K split;
    every segment dead; odd Nb; an unsplit pair with dead segments (E = 8,
    N = 2048); a misaligned A on mma_sync. Before each kernel call a freed
    NaN buffer of the output's size lies where the output is allocated, so
    an element the kernel does not store shows; rows at or past the count
    must be exactly 0. bf16 / f16 output 2e-2 / 1e-3 (f32 sums in other
    orders, one rounding). Returns (failed tags, launches by body of each
    wrapper over the checks)."""
    gg, ref, tf = ks["gg"], ks["ref"], ks["tf"]
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    bf16 = torch.bfloat16
    k2, k3 = gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed
    fails = []
    seen = {f.__name__: dict.fromkeys(f.variants, 0) for f in (k2, k3)}

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * std

    def a_view(e, s, c, k, dtype=bf16):
        """[E, S, C, K] view, row stride a multiple of 8, NaN past K."""
        buf = torch.full((e, s, c, -(-k // 8) * 8 + 8), math.nan, device=DEVICE)
        buf[..., :k] = randn(e, s, c, k)
        return buf.to(dtype)[..., :k]

    def stacks(e, k, n, bk, layout, dtype=bf16, pair=True):
        fmt = tf.TileFormat(bk=bk, bn=64, layout=layout,
                            dtype=str(dtype).split(".")[-1])
        bps = [ref.pack_b_grouped_ref(randn(e, k, n, std=0.05).to(dtype), fmt)
               for _ in range(2 if pair else 1)]
        return fmt, bps[0], (bps[1] if pair else None)

    def check(tag, body, a, bp, n, counts=None, **kw):
        fn = k3 if counts is None else k2
        args = (a, bp, n) if counts is None else (a, bp, n, counts)
        out_shape = tuple(a.shape[:-1]) + (n,)
        poison = torch.full(out_shape, math.nan, device=DEVICE,
                            dtype=kw.get("out_dtype") or a.dtype)
        del poison
        before = dict(fn.variants)
        try:
            got = fn(*args, **kw)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            return
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        for v in ran:
            seen[fn.__name__][v] += fn.variants[v] - before[v]
        plain = (gg.gemm_grouped_packed_plain if counts is None
                 else gg.gemm_grouped_packed_ragged_plain)
        ok, err = close(got, plain(*args, **kw), 2e-2, 1e-3)
        zeros = True
        if counts is not None:
            mask = ref.ragged_row_mask(a.shape[2], counts.clamp(0, a.shape[2]))
            zeros = not bool(got[~mask].any())
        ok = ok and zeros and ran == [body]
        if not ok:
            fails.append(tag)
        if not ok or not quiet:
            log(f"  check {tag} [{'+'.join(ran)}; want {body}]: max_abs_err="
                f"{err:.3e}, zeros past counts {zeros} (rtol=2e-2, atol=1e-3) "
                f"{'ok' if ok else 'FAIL'}")

    def counts_of(rows):
        return torch.tensor(rows, dtype=torch.int32, device=DEVICE)

    e, s, k, n = 3, 2, 700, 200
    bias = randn(e, n)
    packs = {(bk, lay): stacks(e, k, n, bk, lay)
             for bk, lay in ((64, "row"), (128, "col"), (128, "row"))}
    for c in K2_EDGE_C:
        counts = counts_of([[0, c], [c // 2, 1], [c + 7, -2]])
        a = a_view(e, s, c, k)
        for (bk, lay), (fmt, bp, b2p) in packs.items():
            check(f"K2 pair+bias C={c} K={k} N={n} bk {bk} {lay}", k2_body(c),
                  a, bp, n, counts, b2_packed=b2p, b_format=fmt,
                  epilogue="silu_gate", bias=bias)
        fmt, bp, b2p = packs[(64, "row")]
        check(f"K3 pair M={c} K={k} N={n}", k2_body(c), a_view(e, 1, c, k)[:, 0],
              bp, n, b2_packed=b2p, b_format=fmt, epilogue="silu_gate")
    fmt, bp, _ = packs[(128, "row")]
    for c in (8, 160):
        counts = counts_of([[0, c], [c // 2, 1], [c + 7, -2]])
        for epi in EPIS:
            check(f"K2 {epi}+bias C={c} K={k} N={n}", k2_body(c),
                  a_view(e, s, c, k), bp, n, counts, b_format=fmt,
                  epilogue=epi, bias=bias)
        dead = counts_of([[0, 0]] * e)
        check(f"K2 pair every segment dead C={c}", k2_body(c),
              a_view(e, s, c, k), bp, n, dead, b2_packed=packs[(128, "row")][2],
              b_format=fmt, epilogue="silu_gate")
        fmt_h, bp_h, b2p_h = stacks(e, k, n, 64, "col", torch.float16)
        check(f"K2 f16 pair+bias C={c}", k2_body(c),
              a_view(e, s, c, k, torch.float16), bp_h, n, counts,
              b2_packed=b2p_h, b_format=fmt_h, epilogue="silu_gate", bias=bias)
        # A permuted: [S, E, C, K] storage read as [E, S, C, K].
        kp = 768
        fmt_p, bp_p, b2p_p = stacks(e, kp, n, 128, "row")
        a_p = randn(s, e, c, kp).to(bf16).permute(1, 0, 2, 3)
        check(f"K2 pair S=2 permuted A (sa_e {a_p.stride(0)} < sa_s "
              f"{a_p.stride(1)}) C={c}", k2_body(c), a_p, bp_p, n, counts,
              b2_packed=b2p_p, b_format=fmt_p, epilogue="silu_gate")
        fmt_o, bp_o, _ = stacks(e, k, 136, 64, "row", pair=False)
        check(f"K2 gelu+bias N=136 (odd Nb) C={c}", k2_body(c),
              a_view(e, s, c, k), bp_o, 136, counts, b_format=fmt_o,
              epilogue="gelu", bias=randn(e, 136))
        a_m = randn(e, s, c, 320).to(bf16)[..., 5:305]
        fmt_m, bp_m, b2p_m = stacks(e, 300, n, 128, "row")
        check(f"K2 pair A offset 5 (misaligned) C={c}", "mma_sync", a_m, bp_m,
              n, counts, b2_packed=b2p_m, b_format=fmt_m, epilogue="silu_gate")
    for bk, lay in ((64, "row"), (128, "col")):
        fmt1, bp1, b2p1 = stacks(2, k, n, bk, lay)
        check(f"K2 pair one live segment, K split, bk {bk} {lay}", "tc_stream",
              a_view(2, 1, 8, k), bp1, n, counts_of([[5], [0]]),
              b2_packed=b2p1, b_format=fmt1, epilogue="silu_gate")
    fmt8, bp8, b2p8 = stacks(8, 2048, 2048, 128, "row")
    counts8 = counts_of([[2, 0], [8, 1], [0, 0], [3, 5], [8, 8], [0, 1],
                         [4, 0], [1, 2]])
    check("K2 pair unsplit E=8 S=2 K=2048 N=2048, dead segments", "tc_stream",
          a_view(8, 2, 8, 2048), bp8, 2048, counts8, b2_packed=b2p8,
          b_format=fmt8, epilogue="silu_gate", bias=randn(8, 2048))
    check("K2 unsplit E=8 S=2 C=16 K=2048 N=2048, dead segments", "tc_stream",
          a_view(8, 2, 16, 2048), bp8, 2048, counts8 * 2, b_format=fmt8)
    return fails, seen


def phase_grouped(torch, gg, ref, tf):
    """K2 and K3 against their plain versions on the card, and their times
    (CUDA events and device time) at mixtral-8x22b's expert shapes, each
    held to the body it must take (tc_stream at the decode envelope, wgmma
    at prefill); then k2_checks at the TMA bodies' edges and PR 12's
    bodies at the quantized and f32 / int8 formats. Returns (timing rows,
    max abs error at the main shapes)."""
    import torch.nn.functional as F
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(2)
    cpu_gen = torch.Generator().manual_seed(3)
    fails = []
    rows = []

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def check(tag, a, bp, n, counts, rtol, atol, body=None, **kw):
        """K2 on [E, S, C, K] and K3 on the same A as [E, S*C, K]; with
        ``body``, each must launch that body."""
        e, s, c, k = a.shape
        before = {f.__name__: dict(f.variants) for f in (
            gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed)}
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
        ran = {f.__name__: [v for v, n_ in f.variants.items()
                            if n_ != before[f.__name__][v]]
               for f in (gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed)}
        good = ok and zeros and ok3 and (
            body is None or all(r == [body] for r in ran.values()))
        log(f"  check {tag}: K2 max_abs_err={err:.3e} zeros past counts "
            f"{zeros}, K3 max_abs_err={err3:.3e} (rtol={rtol}, atol={atol}); "
            f"bodies {ran}{f' (want {body})' if body else ''} "
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
            body = k2_body(c)
            main_err = max(main_err, check(
                f"mixtral {name} {env} E=8 C={c} K={k} N={n}", a, packed[0],
                n, counts, 2e-2, 1e-3, body=body, **kw))
            a3 = a.reshape(MIX_E, c, k)

            def lib(i):
                out = torch.bmm(a3, w_nat[0])
                if pair:
                    out = F.silu(out) * torch.bmm(a3, w_nat[1])
                return out
            reps = 5 if env == "decode" else 3

            def k2_call(i):
                gg.gemm_grouped_packed_ragged(a, packed[0], n, counts, **kw)

            def k3_call(i):
                gg.gemm_grouped_packed(a3, packed[0], n, **kw)
            t = dict(
                k2=time_ms(k2_call, reps), k2_device=device_ms(k2_call, reps),
                k2_plain=time_ms(lambda i: gg.gemm_grouped_packed_ragged_plain(
                    a, packed[0], n, counts, **kw), 2),
                k3=time_ms(k3_call, reps), k3_device=device_ms(k3_call, reps),
                k3_plain=time_ms(lambda i: gg.gemm_grouped_packed_plain(
                    a3, packed[0], n, **kw), 2),
                library=time_ms(lib, reps), library_device=device_ms(lib, reps))
            b2, by2 = grouped_bound_ms(counts_h, MIX_E, c, k, n, b_bytes, pair)
            b3, by3 = grouped_bound_ms(None, MIX_E, c, k, n, b_bytes, pair)
            rows.append(dict(contraction=name, envelope=env, e=MIX_E, s=1,
                             c=c, k=k, n=n, counts=counts_h.tolist(),
                             variant=body, k2_ms=t["k2"],
                             k2_device_ms=t["k2_device"],
                             k2_plain_ms=t["k2_plain"], k2_bound_ms=b2,
                             k2_bound_by=by2, k3_ms=t["k3"],
                             k3_device_ms=t["k3_device"],
                             k3_plain_ms=t["k3_plain"], k3_bound_ms=b3,
                             k3_bound_by=by3, library_ms=t["library"],
                             library_device_ms=t["library_device"]))
            log(f"  time {name} {env} C={c} ({body}): K2 {t['k2']:.4f} ms "
                f"(device {t['k2_device']:.4f}; bound {b2:.4f}, {by2}; plain "
                f"{t['k2_plain']:.4f}), K3 {t['k3']:.4f} ms (device "
                f"{t['k3_device']:.4f}; bound {b3:.4f}, {by3}; plain "
                f"{t['k3_plain']:.4f}), torch.bmm"
                f"{' x2 + silu*mul' if pair else ''} {t['library']:.4f} ms "
                f"(device {t['library_device']:.4f})")
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
    edge_fails, edge_seen = k2_checks(torch, dict(gg=gg, ref=ref, tf=tf))
    log(f"  K2 / K3 edge checks, launches by body: {edge_seen}")
    fails += edge_fails
    if fails:
        raise AssertionError(f"grouped kernel disagrees with its plain "
                             f"version: {fails}")
    return rows, main_err


H100_F32_FLOPS = hw.H100.peak_f32_flops     # f32 FMA on the CUDA cores
EPIS = ("none", "relu", "gelu", "silu", "tanh")


def same_bytes(torch, got, want) -> bool:
    """Byte-for-byte equality of two tensors (shape and dtype included)."""
    return (tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
            and torch.equal(got.contiguous().view(torch.uint8),
                            want.contiguous().view(torch.uint8)))


def gemm_bound_ms(m, k, n, a_bytes, b_bytes, out_item, peak):
    """Least time of one GEMM: operations over ``peak`` against A and B
    read once and the [m, n] output written once over the HBM rate."""
    flops = float(GemmProblem(m=m, n=n, k=k).flops)
    nbytes = a_bytes + b_bytes + m * n * out_item
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


# K6 / K8 edge shapes: rows on both sides of each body's limits (16 rows for
# the decode bodies, 64 / 128-row tiles above), N and K off every block,
# K = 8192 at decode (split K).
EDGE_M = (1, 4, 16, 17, 64, 65, 512)
EDGE_N = 200


def k6_k8_checks(torch, ks, quiet=False) -> tuple:
    """K8 (both entry points) and K6 against their plain versions at the
    edge shapes: f32 and bf16 at 1e-4 for K8 (bf16 widens exactly, f32
    sums), bf16 output 2e-2 / 1e-3 and f32 1e-4 for K6, int8 exact; A
    offset by 5 elements (no 16-byte loads), the LM head's table.t() as B,
    the planner's packed tiles in every layout pair, and tiles it does not
    emit (bm 16 / 32 / 48, bk 64, bn 32) for K6's general body. Returns
    (failed tags, launches by body of each wrapper over the checks)."""
    pk, gp, gv = ks["pack"], ks["gp"], ks["gv"]
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    fails = []
    seen = {f.__name__: dict.fromkeys(f.variants, 0) for f in (
        gp.gemm_packed, gv.matmul_vsx_like, gv.matmul_vsx_like_packed)}

    def randn(*shape, std=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=DEVICE) * std).to(dtype)

    def randi(*shape):
        return torch.randint(-100, 100, shape, generator=gen, device=DEVICE,
                             dtype=torch.int8)

    def check(tag, fn, plain, args, kw, rtol, atol):
        before = dict(fn.variants)
        try:
            got = fn(*args, **kw)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            return
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        for v in ran:
            seen[fn.__name__][v] += fn.variants[v] - before[v]
        ok, err = close(got, plain(*args, **kw), rtol, atol)
        if not ok:
            fails.append(tag)
        if not ok or not quiet:
            log(f"  check {tag} [{'+'.join(ran)}]: max_abs_err={err:.3e} "
                f"(rtol={rtol}, atol={atol}) {'ok' if ok else 'FAIL'}")

    for m in EDGE_M:
        k, n = (8192 if m <= 16 else 750), EDGE_N
        for dt in (f32, bf16):
            nm = "f32" if dt == f32 else "bf16"
            a, w = randn(m, k, dtype=dt), randn(k, n, std=0.05, dtype=dt)
            shifted = randn(m, k + 5, dtype=dt)[:, 5:]
            table = randn(n, k, std=0.05, dtype=dt)
            check(f"matmul_vsx_like {nm} M={m} K={k} N={n}", gv.matmul_vsx_like,
                  gv.matmul_vsx_like_plain, (a, w), dict(out_dtype=f32), 1e-4, 1e-4)
            check(f"matmul_vsx_like {nm} M={m} A offset 5, B table.t()",
                  gv.matmul_vsx_like, gv.matmul_vsx_like_plain, (shifted, table.t()),
                  dict(out_dtype=f32), 1e-4, 1e-4)
            for bk, bn, lb in ((64, 32, "row"), (128, 64, "col")):
                check(f"matmul_vsx_like_packed {nm} M={m} bk {bk} bn {bn} {lb}",
                      gv.matmul_vsx_like_packed, gv.matmul_vsx_like_packed_plain,
                      (a, pk.pack_b_plain(w, bk, bn, lb), n),
                      dict(layout_b=lb, out_dtype=f32), 1e-4, 1e-4)
        ai, wi = randi(m, k), randi(k, n)
        check(f"matmul_vsx_like int8 M={m} -> int32 (exact)", gv.matmul_vsx_like,
              gv.matmul_vsx_like_plain, (ai, wi), dict(out_dtype=torch.int32), 0.0, 0.0)
        a, w = randn(m, k, dtype=bf16), randn(k, n, std=0.05, dtype=bf16)
        c, bias = randn(m, n), randn(n)
        plan_bm = 16 if m <= 16 else 64
        geoms = [(plan_bm, 128, 64, la, lb) for la in ("row", "col")
                 for lb in ("row", "col")]
        geoms += [(16 if m <= 16 else 32, 64, 32, "row", "col"),
                  (48, 64, 32, "col", "row")]
        for bm, bk, bn, la, lb in geoms:
            check(f"gemm_packed bf16 M={m} bm {bm} bk {bk} bn {bn} {la}/{lb}",
                  gp.gemm_packed, gp.gemm_packed_plain,
                  (pk.pack_a_plain(a, bm, bk, la), pk.pack_b_plain(w, bk, bn, lb), m, n),
                  dict(c=c, alpha=1.5, beta=0.5, bias=bias, epilogue="tanh",
                       layout_a=la, layout_b=lb), 2e-2, 1e-3)
        a32, w32 = a.float(), w.float()
        check(f"gemm_packed f32 M={m} bm {plan_bm} col/col", gp.gemm_packed,
              gp.gemm_packed_plain,
              (pk.pack_a_plain(a32, plan_bm, 128, "col"), pk.pack_b_plain(w32, 128, 64, "col"),
               m, n), dict(bias=bias, epilogue="gelu", layout_a="col", layout_b="col"),
              1e-4, 1e-4)
        check(f"gemm_packed int8 M={m} -> int32 (exact)", gp.gemm_packed,
              gp.gemm_packed_plain,
              (pk.pack_a_plain(ai, plan_bm, 64), pk.pack_b_plain(wi, 64, 32), m, n),
              dict(out_dtype=torch.int32), 0.0, 0.0)
    return fails, seen


# K7 edge shapes: rows on both sides of 16 (tc_stream / wgmma) and of a
# 64 / 128-row tile, K with a part-padding last box (700) and K = 8192 at
# decode (split K), N with a ragged last stripe (200).
K7_EDGE_M = (1, 4, 16, 17, 64, 512)
K7_EDGE_K = (700, 2048, 8192)


def k7_body(m):
    """K7's body for bf16 / f16 operands that TMA can read."""
    return "tc_stream" if m <= 16 else "wgmma"


def k7_checks(torch, ks, quiet=False) -> tuple:
    """K7 against its plain version at its TMA bodies' edges, each call also
    held to the body it must take, which must be the one ``tiled_body``
    names: A as a view whose columns past K hold NaN (A's map must be K
    wide); B row-major as a column slice whose columns past N hold NaN, and
    B as ``table.t()`` of an [N, K] slice whose columns past K hold NaN
    (the transposed view's map must be K wide); M 1 ... 512, K 700 / 2048 /
    8192 at N = 200; N 8192 and the LM head's 50304 at M 4 and 512; every
    epilogue with c, alpha, beta and bias at M=4 split (N = 2048) and
    unsplit (N = 17000) and at M=512; an A offset by 5 elements on
    mma_general; f16; a bf16 product stored as f32; one block
    (``single_block``) at M 4 and 512; f32 / int8 on the CUDA-core bodies.
    Before each call a freed NaN buffer of the output's size lies where
    the output is allocated, so an element the kernel does not store
    shows. bf16 / f16 output 2e-2 / 1e-3 (f32 sums in other orders, one
    rounding), f32 output 1e-4, int8 exact. Returns (failed tags, launches
    by body over the checks)."""
    gt = ks["gt"]
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    fn = gt.gemm_tiled
    fails, seen = [], dict.fromkeys(fn.variants, 0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * std

    def padded(rows, cols, dtype=bf16, std=1.0):
        """[rows, cols] view of a buffer whose columns past ``cols`` hold
        NaN (row stride a multiple of 8)."""
        buf = torch.full((rows, -(-cols // 8) * 8 + 8), math.nan, device=DEVICE)
        buf[:, :cols] = randn(rows, cols, std=std)
        return buf.to(dtype)[:, :cols]

    def weights(k, n, dtype=bf16):
        return {"row-major, NaN past N": padded(k, n, dtype, 0.05),
                "table.t(), NaN past K": padded(n, k, dtype, 0.05).t()}

    def check(tag, want, a, b, rtol=2e-2, atol=1e-3, **kw):
        named = gt.tiled_body(a.dtype, a.shape[0], gt.tiled_tma_aligned(a, b))
        out_dtype = kw.get("out_dtype") or (kw["c"].dtype if "c" in kw else a.dtype)
        poison = torch.full((a.shape[0], b.shape[1]), math.nan if
                            out_dtype.is_floating_point else -2 ** 31,
                            device=DEVICE, dtype=out_dtype)
        del poison
        before = dict(fn.variants)
        try:
            got = fn(a, b, **kw)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            return
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        for v in ran:
            seen[v] += fn.variants[v] - before[v]
        ok, err = close(got, gt.gemm_tiled_plain(a, b, **kw), rtol, atol)
        ok = ok and ran == [want] == [named]
        if not ok:
            fails.append(tag)
        if not ok or not quiet:
            log(f"  check {tag} [{'+'.join(ran)}; want {want}, tiled_body "
                f"{named}]: max_abs_err={err:.3e} (rtol={rtol}, atol={atol}) "
                f"{'ok' if ok else 'FAIL'}")

    n = EDGE_N
    for k in K7_EDGE_K:
        bs = weights(k, n)
        for m in K7_EDGE_M:
            a = padded(m, k)
            for lay, b in bs.items():
                check(f"K7 bf16 NaN-padded A M={m} K={k} N={n} B {lay}", k7_body(m),
                      a, b)
    for nn in (8192, 50304):
        bs = weights(2048, nn)
        for m in (4, 512):
            a = padded(m, 2048)
            for lay, b in bs.items():
                check(f"K7 bf16 M={m} K=2048 N={nn} B {lay}", k7_body(m), a, b)
        del bs
    # Every epilogue once after the split sum (M=4, N=2048: K split in 11),
    # unsplit (M=4, N=17000: 266 stripes) and on wgmma (M=512).
    for m, k, nn in ((4, 2048, 2048), (4, 700, 17000), (512, 2048, 2048)):
        bs = list(weights(k, nn).items())
        a, c, bias = padded(m, k), randn(m, nn), randn(nn)
        for i, epi in enumerate(EPIS):
            lay, b = bs[i % 2]
            check(f"K7 bf16 M={m} K={k} N={nn} B {lay} {epi}+bias, c, alpha, beta",
                  k7_body(m), a, b, c=c, alpha=1.5, beta=0.5, bias=bias, epilogue=epi)
    w = padded(300, n, std=0.05)
    for m in (4, 37):
        check(f"K7 bf16 A offset 5 (misaligned) M={m}", "mma_general",
              randn(m, 320).to(bf16)[:, 5:305], w, epilogue="gelu")
    for m in (4, 512):
        for lay, b in weights(700, n, f16).items():
            check(f"K7 f16 M={m} K=700 N={n} B {lay}", k7_body(m),
                  padded(m, 700, f16), b)
        for lay, b in weights(2048, n).items():
            check(f"K7 bf16 -> f32 M={m} K=2048 N={n} B {lay}", k7_body(m),
                  padded(m, 2048), b, 1e-4, 1e-4, out_dtype=f32)
    # One block walks every item: 32 stripes at M=4, 8 tiles at M=512.
    for m, k, nn in ((4, 2048, 2048), (512, 700, 200)):
        for lay, b in weights(k, nn).items():
            check(f"K7 bf16 one block M={m} K={k} N={nn} B {lay} c, alpha, beta",
                  k7_body(m), padded(m, k), b, single_block=True, c=randn(m, nn),
                  alpha=0.5, beta=2.0)
    for m in (4, 512):
        body = "fma_stream" if m <= 16 else "fma_tiled"
        check(f"K7 f32 M={m} K=700 N={n} B table.t() silu", body,
              padded(m, 700, f32), padded(n, 700, f32, 0.05).t(), 1e-4, 1e-4,
              epilogue="silu")
        ai = torch.randint(-100, 100, (m, 750), generator=gen, device=DEVICE,
                           dtype=torch.int8)
        wi = torch.randint(-100, 100, (750, n), generator=gen, device=DEVICE,
                           dtype=torch.int8)
        check(f"K7 int8 M={m} K=750 N={n} -> int32 (exact)", body, ai, wi, 0.0,
              0.0, out_dtype=torch.int32)
    return fails, seen


# K5 checks, (wrapper, dtype, scale granularity, layout, shape of X, view,
# tile (bm, bk) of pack_a / (bk, bn) of pack_b, the body it must take):
# phase 1's original cases, then each body's edges. Views: "contig";
# "padded", a column slice of a buffer wider by at least 64 columns of
# random values (a row stride past C, C off whole tiles: a map as wide as
# the stride would read them); "t", "t_padded", the transpose of a [C, R]
# matrix or of such a slice; "offset", one element past a 16-byte
# boundary; "step2", every second column. A quantized format quantizes f32
# values (the kernel then sees them zero-padded to whole tiles).
K5_FORMATS = [("float32", None), ("bfloat16", None), ("int8", None),
              ("int8", "tile"), ("int8", "col"), ("int4", "tile"),
              ("int4", "col")]


def k5_format_body(dtype, gran, layout):
    """The body of phase 1's format cases at (300, 200) with 64 x 32 tiles:
    raw int8 rows are 200 bytes (off 16), the rest take TMA; the row layout
    of a float or int8 X is its box as it lies, anything else a stage."""
    if dtype == "int8" and gran is None:
        return "general"
    return "tma_copy" if layout == "row" and dtype != "int4" else "tma_stage"


K5_CASES = (
    [("pack_a", dt, None, lay, (37, 70), "contig", (16, 32), "general")
     for lay in ("row", "col") for dt in ("float32", "bfloat16", "int8")]
    + [(fn, dt, gran, lay, shape, "contig", (64, 32), k5_format_body(dt, gran, lay))
       for lay in ("row", "col") for dt, gran in K5_FORMATS
       for fn, shape in (("pack_b", (300, 200)), ("pack_b_grouped", (3, 300, 200)))]
    + [("pack_b", "bfloat16", None, "row", (300, 200), "t", (128, 64), "general"),
       # tma_copy: ragged R and C under a wider row stride, tiles 16 ... 256
       ("pack_b", "bfloat16", None, "row", (300, 200), "padded", (64, 32), "tma_copy"),
       ("pack_b_grouped", "bfloat16", None, "row", (3, 300, 200), "padded", (64, 32),
        "tma_copy"),
       ("pack_b", "bfloat16", None, "row", (300, 200), "padded", (16, 16), "tma_copy"),
       ("pack_b", "bfloat16", None, "row", (300, 200), "padded", (128, 64), "tma_copy"),
       ("pack_b", "bfloat16", None, "row", (600, 300), "padded", (256, 128), "tma_copy"),
       ("pack_a", "bfloat16", None, "row", (300, 200), "padded", (64, 32), "tma_copy"),
       ("pack_b", "int8", None, "row", (300, 200), "padded", (64, 32), "tma_copy"),
       ("pack_b", "float32", None, "col", (300, 200), "t_padded", (64, 32), "tma_copy"),
       # tma_stage: transposes of a row-major X, table.t() in the row layout
       ("pack_b", "float32", None, "col", (300, 200), "padded", (64, 32), "tma_stage"),
       ("pack_b", "bfloat16", None, "col", (300, 200), "padded", (64, 32), "tma_stage"),
       ("pack_a", "bfloat16", None, "col", (300, 200), "padded", (64, 32), "tma_stage"),
       ("pack_b", "int8", None, "col", (300, 200), "padded", (64, 32), "tma_stage"),
       ("pack_b", "bfloat16", None, "row", (300, 200), "t_padded", (128, 64), "tma_stage"),
       ("pack_b_grouped", "bfloat16", None, "row", (3, 300, 200), "t_padded", (128, 64),
        "tma_stage"),
       ("pack_b", "float32", None, "col", (600, 300), "padded", (256, 128), "tma_stage"),
       # general: what TMA cannot read
       ("pack_b", "bfloat16", None, "row", (300, 200), "offset", (64, 32), "general"),
       ("pack_b", "float32", None, "col", (300, 200), "offset", (64, 32), "general"),
       ("pack_b", "bfloat16", None, "row", (300, 200), "step2", (64, 32), "general"),
       ("pack_b", "bfloat16", None, "row", (37, 70), "contig", (64, 32), "general"),
       ("pack_b", "float64", None, "row", (300, 200), "contig", (64, 32), "general"),
       ("pack_b", "int64", None, "col", (300, 200), "contig", (64, 32), "general"),
       ("pack_b", "bfloat16", None, "row", (600, 200), "contig", (512, 64), "general"),
       # extent-1 dims: K = 1, N = 1 (a column, and a column of table.t()),
       # E = 1, a 1 x 1 matrix
       ("pack_b", "bfloat16", None, "row", (1, 200), "contig", (64, 32), "tma_copy"),
       ("pack_b", "bfloat16", None, "row", (300, 1), "contig", (64, 32), "tma_stage"),
       ("pack_b", "bfloat16", None, "col", (300, 1), "t", (64, 32), "tma_copy"),
       ("pack_b_grouped", "bfloat16", None, "row", (1, 300, 200), "padded", (64, 32),
        "tma_copy"),
       ("pack_b", "float32", None, "row", (1, 1), "contig", (64, 32), "tma_copy")])

def k5_input(torch, gen, device, dtype, gran, shape, view):
    """X of a K5 case: values from ``gen`` on ``device`` laid out as
    ``view`` says (K5_CASES); f32 values for a quantized format."""
    dt = getattr(torch, "float32" if gran else dtype)

    def values(*s):
        if dt.is_floating_point:
            return torch.randn(s, generator=gen, device=device).to(dt)
        return torch.randint(-100, 100, s, generator=gen, device=device, dtype=dt)
    *lead, r, c = shape
    if view == "contig":
        return values(*shape)
    if view == "padded":
        return values(*lead, r, -(-c // 64) * 64 + 64)[..., :c]
    if view == "t":
        return values(*lead, c, r).transpose(-2, -1)
    if view == "t_padded":
        return values(*lead, c, -(-r // 64) * 64 + 64)[..., :r].transpose(-2, -1)
    if view == "offset":
        return values(math.prod(shape) + 1)[1:].view(shape)
    if view == "step2":
        return values(*lead, r, 2 * c)[..., ::2]
    raise ValueError(f"unknown view {view!r}")


def k5_call(pk, tf, fn, dtype, gran, layout, tile):
    """(kernel wrapper, plain version, its arguments after X) of a case."""
    if fn == "pack_a":
        return pk.pack_a, pk.pack_a_plain, (*tile, layout)
    scale = dict(scale=tf.ScaleSpec(granularity=gran)) if gran else {}
    fmt = tf.TileFormat(bk=tile[0], bn=tile[1], layout=layout, dtype=dtype, **scale)
    return ((pk.pack_b, pk.pack_b_plain) if fn == "pack_b"
            else (pk.pack_b_grouped, pk.pack_b_grouped_plain)) + ((fmt,),)


def k5_launched(pk, fn, x, args) -> tuple:
    """(X as the kernel sees it, [E, R, C]; b0, b1, transpose, nibble) of a
    wrapper call: pack_a's and pack_b's X as a stack of one, a quantized
    format's values after quantizing."""
    if fn == "pack_a":
        bm, bk, layout = args
        return x[None], bm, bk, layout == "col", False
    fmt = args[0]
    x3 = x[None] if x.dim() == 2 else x
    if fmt.is_quantized:
        x3 = pk.quantize_natural(x3, fmt)[0]
    return x3, fmt.bk, fmt.bn, fmt.layout == "col", fmt.sub_byte


def k5_reach(pk, x3, b0, b1, transpose, nibble) -> dict:
    """What a planted fault of K5_FAULTS needs to show at a call: its body,
    and whether a map as wide as the row stride reads past X's unit-stride
    extent into values (the extent off whole tiles under a wider stride
    between rows; a single row or column has no neighbour to read)."""
    body = pk.pack_body(x3, b0, b1, transpose, nibble)
    plan = pk.pack_plan(x3, b0, b1, transpose, nibble)
    wide = False
    if plan is not None:
        _, r, c = x3.shape
        _, sr, sc = pk.pack_strides(x3)
        ext_u, ext_v, sv, bu = (c, r, sr, b1) if plan.unit == "c" else (r, c, sc, b0)
        wide = ext_v > 1 and sv > ext_u and ext_u % bu != 0
    return dict(body=body, wide=wide)


def k5_checks(torch, ks, quiet=False, reach=None) -> tuple:
    """K5 against the plain packers, byte for byte, at every case of
    K5_CASES, each call held to the body K5_CASES names, which must be the
    one ``pack_body`` names (read from ``.variants``). Before each call a
    freed block of the output's size filled with 0xFF bytes lies where the
    caching allocator hands out the output, so a chunk the kernel does not
    store shows (logged: how often the block came back). Then empty
    operands, which launch and count nothing. ``reach``, a dict, gets each
    case's ``k5_reach``. Returns (failed tags, launches by body)."""
    pk, tf = ks["pack"], ks["tf"]
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    fails = []
    seen = dict.fromkeys(pk.PACK_BODIES, 0)
    landed = 0
    for i, (fn_name, dtype, gran, layout, shape, view, tile, want) in enumerate(K5_CASES):
        tag = (f"K5 {i} {fn_name} {dtype}{':' + gran if gran else ''} {layout} "
               f"{shape} {view} tile {tile}")
        x = k5_input(torch, gen, DEVICE, dtype, gran, shape, view)
        fn, plain, args = k5_call(pk, tf, fn_name, dtype, gran, layout, tile)
        launched = k5_launched(pk, fn_name, x, args)
        named = pk.pack_body(*launched)
        if reach is not None:
            reach[tag] = k5_reach(pk, *launched)
        want_out = plain(x, *args)
        want_t = want_out if isinstance(want_out, tuple) else (want_out,)
        poison = torch.full((want_t[0].numel() * want_t[0].element_size(),), 0xFF,
                            dtype=torch.uint8, device=DEVICE)
        spot = poison.data_ptr()
        del poison
        before = dict(fn.variants)
        try:
            got = fn(x, *args)
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            continue
        got_t = got if isinstance(got, tuple) else (got,)
        landed += got_t[0].data_ptr() == spot
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        for v in ran:
            seen[v] += fn.variants[v] - before[v]
        same = len(got_t) == len(want_t) and all(
            same_bytes(torch, g, w) for g, w in zip(got_t, want_t))
        ok = same and ran == [want] == [named]
        if not ok:
            fails.append(tag)
        if not ok or not quiet:
            log(f"  check {tag} [{'+'.join(ran)}; want {want}, pack_body {named}]: "
                f"byte-equal {same} {'ok' if ok else 'FAIL'}")
    log(f"  K5: the 0xFF block came back under {landed} of {len(K5_CASES)} outputs")
    fmt = ks["tf"].TileFormat(bk=128, bn=64, dtype="bfloat16")
    before = {f.__name__: f.launches for f in (pk.pack_a, pk.pack_b, pk.pack_b_grouped)}
    pk.pack_a(torch.zeros((0, 70), device=DEVICE), 16, 32)
    pk.pack_b(torch.zeros((0, 200), device=DEVICE), fmt)
    pk.pack_b_grouped(torch.zeros((0, 300, 200), device=DEVICE), fmt)
    after = {f.__name__: f.launches for f in (pk.pack_a, pk.pack_b, pk.pack_b_grouped)}
    if after != before:
        fails.append("K5 empty operands")
        log(f"  check K5 empty operands: counts {after} (before {before}) FAIL")
    return fails, seen


def k5_times(torch, pk, tf) -> tuple:
    """K5 at the shapes the served paths pack (bf16, bk 128 bn 64, row):
    each olmo-1b projection (the raw prefill packs them per call), the LM
    head as table.t() (packed at load) and one mixtral-8x22b expert stack
    (pack_b_grouped at load). At each: byte-equal to the plain packer, on
    the body ``pack_body`` names; CUDA events and device time (the mean a
    recorded launch, ``launch_ms``) of the wrapper, of the library
    yardstick (one strided copy, ``reshape(Kb, bk, Nb, bn).permute(2, 0,
    1, 3).contiguous()``: the same function at these tile-aligned float
    shapes, byte-equal too) and of the ``general`` body (the C entry called
    with that body, a measurement only, also byte-equal); the plain packer
    in events; the byte bound (X read once, the buffer written once).
    Returns (rows, failed tags)."""
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    bk, bn = 128, 64
    fmt = tf.TileFormat(bk=bk, bn=bn, dtype="bfloat16")
    rows, fails = [], []
    shapes = [(None, k, n) for k, n in OLMO_SHAPES] + [(MIX_E, MIX_D, MIX_F)]
    for e, k, n in shapes:
        head = (k, n) == (2048, 50304)
        nbytes = (e or 1) * k * n * 2
        copies = max(1, min(16, math.ceil(128e6 / nbytes)))

        def randn(*s):
            return (torch.randn(s, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        # The LM head is packed as table.t(), a transposed view.
        xs = [randn(e, k, n) if e else randn(n, k).t() if head else randn(k, n)
              for _ in range(copies)]
        fn, plain = ((pk.pack_b_grouped, pk.pack_b_grouped_plain) if e
                     else (pk.pack_b, pk.pack_b_plain))
        lead = (e,) if e else ()
        perm = (0, 3, 1, 2, 4) if e else (2, 0, 1, 3)

        def library(i):
            return xs[i % copies].reshape(*lead, k // bk, bk, n // bn, bn).permute(
                *perm).contiguous()
        x3s = [x if e else x[None] for x in xs]
        body = pk.pack_body(x3s[0], bk, bn, False, False)
        expect = "tma_stage" if head else "tma_copy"   # table.t() transposes
        want = plain(xs[0], fmt)
        before = dict(fn.variants)
        got = fn(xs[0], fmt)
        torch.cuda.synchronize()
        ran = [v for v, c in fn.variants.items() if c != before[v]]
        outs = [torch.empty_like(want) for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream

        def general(i):
            rc = pk._kernel()(*pk.launch_args(
                x3s[i % copies], bk, bn, col_order=True, transpose=False,
                nibble=False, body="general", out=outs[i % 2], stream=stream))
            if rc != 0:
                raise RuntimeError(f"K5 general launch failed: CUDA error {rc}")
        general(0)
        torch.cuda.synchronize()
        tag = f"K5 times {'pack_b_grouped E=' + str(e) if e else 'pack_b'} K={k} N={n}"
        ok = (same_bytes(torch, got, want) and ran == [body] == [expect]
              and same_bytes(torch, library(0).view(want.shape), want)
              and same_bytes(torch, outs[0], want))
        err = float((got.float() - want.float()).abs().max())
        del got, want
        if not ok:
            fails.append(tag)
        reps = 5 if e else 20
        call = (lambda i: fn(xs[i % copies], fmt))
        t_k = time_ms(call, reps)
        t_dev, kept, lost = launch_ms(call, reps)
        t_lib = time_ms(library, reps)
        t_lib_dev, kept_lib, lost_lib = launch_ms(library, reps)
        t_gen_dev, kept_gen, lost_gen = launch_ms(general, max(2, reps // 4))
        if lost:
            t_dev = backed_fallback(call, reps, f"{tag} kernel", lost)
        if lost_lib:
            t_lib_dev = backed_fallback(library, reps, f"{tag} torch copy", lost_lib)
        if lost_gen:
            t_gen_dev = backed_fallback(general, max(2, reps // 4),
                                        f"{tag} general", lost_gen)
        t_plain = time_ms(lambda i: plain(xs[i % copies], fmt), max(2, reps // 4))
        bound = 2 * nbytes / H100_HBM_BYTES * 1e3
        rows.append(dict(kernel="pack_b_grouped" if e else "pack_b", e=e, k=k, n=n,
                         body=body, ms=t_k, device_ms=t_dev, plain_ms=t_plain,
                         library_ms=t_lib, library_device_ms=t_lib_dev,
                         general_device_ms=t_gen_dev, bound_ms=bound, bound_by="bytes",
                         max_abs_err=err, records_kept=min(kept, kept_lib, kept_gen)))
        log(f"  {tag} ({'table.t(), ' if head else ''}{ran}; want {expect}, pack_body "
            f"{body}): byte-equal "
            f"(kernel, library, general) {'ok' if ok else 'FAIL'}; kernel {t_k:.4f} ms "
            f"(device {t_dev:.4f}), torch copy {t_lib:.4f} (device {t_lib_dev:.4f}), "
            f"general device {t_gen_dev:.4f}, plain {t_plain:.4f}, bound {bound:.4f} "
            f"(bytes); records kept {kept} / {kept_lib} / {kept_gen}")
        del xs, x3s, outs
        torch.cuda.empty_cache()
    return rows, fails


# K5's kernel functions, by a piece of their names: both TMA bodies must
# issue the TMA load (UTMALDG) and the bulk store (UBLKCP), the general body
# neither.
K5_TMA_OPS = ("UTMALDG", "UBLKCP")


def check_k5_sass(path) -> str:
    """K5's library, per function: a TMA load and a bulk store (UTMALDG,
    UBLKCP, whatever their suffixes) in every k5_tma_copy and k5_tma_stage,
    neither in k5_general. Returns the opcodes found, by body."""
    import re
    # Whatever cuobjdump calls them: UTMALDG.3D, UBLKCP.S.G, ...
    funcs = sass_by_function(path, lambda line: re.findall(r"\bU(?:TMA|BLK)[A-Z0-9_.]*", line))
    found = {tag: [ops for n, ops in funcs.items() if tag in n]
             for tag in ("k5_tma_copy", "k5_tma_stage", "k5_general")}

    def has(ops, op):
        return any(o.startswith(op) for o in ops)
    bad = [tag for tag in ("k5_tma_copy", "k5_tma_stage")
           if not found[tag] or not all(has(ops, op) for ops in found[tag]
                                        for op in K5_TMA_OPS)]
    if not found["k5_general"] or any(has(ops, op) for ops in found["k5_general"]
                                      for op in K5_TMA_OPS):
        bad.append("k5_general")
    if bad:
        raise AssertionError(f"{path.name}: functions failing their SASS check "
                             f"{bad}: {found}")
    return ", ".join(f"{len(ops)} {tag} ({sorted(set().union(*ops)) or 'none'})"
                     for tag, ops in found.items())


# Faults that ``--planted-faults`` plants in copies of K5's source (name,
# edits of pack.cu, which calls of k5_checks it reaches by their
# ``k5_reach``). k5_checks must fail each at every call it reaches.
K5_FAULTS = [
    # The map as wide as X's row stride: past a ragged edge TMA then reads
    # the row's padding instead of filling zeros.
    ("K5: the source map as wide as its row stride, not X", [
        ("const cuuint64_t width = static_cast<cuuint64_t>(ext_u);",
         "const cuuint64_t width = static_cast<cuuint64_t>(sv);")],
     lambda r: r["wide"]),
    # The block holding the last chunk walks one chunk short: it stays 0xFF.
    ("K5: the persistent walk's last chunk dropped", [
        ("return static_cast<int>((p.chunks - blockIdx.x + gridDim.x - 1) / gridDim.x);",
         "return static_cast<int>((p.chunks - 1 - blockIdx.x + gridDim.x - 1) / gridDim.x);")],
     lambda r: r["body"] != "general"),
    # The stage pass reads its block one 32-bit lane over (transposes) or
    # its vector one over (nibble packing alone); it stays in bounds.
    ("K5: the stage pass's read one lane over", [
        ("load_block<P>(s32, jb, ib, ub, w);",
         "load_block<P>(s32, jb, (ib + 1) % ub, ub, w);"),
        ("const uint4 w = s4[v];", "const uint4 w = s4[(v + 1) % n16];")],
     lambda r: r["body"] == "tma_stage"),
]


def phase_layered(torch, ks, tf):
    """K5 (pack), K6 (gemm_packed), K7 (gemm_tiled) and K8 (matmul_vsx_like
    and its packed variant) against their plain versions on the card, then
    their times at olmo-1b's shapes. Returns (timing rows, max abs error of
    each kernel at the olmo shapes)."""
    pk, gp, gt, gv = ks["pack"], ks["gp"], ks["gt"], ks["gv"]
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(5)
    fails = []
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def randi(*shape, lo=-100, hi=100, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def verdict(tag, ok, detail):
        log(f"  check {tag}: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(tag)

    def check(tag, fn, plain, args, kw, rtol, atol):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        ok, err = close(got, want, rtol, atol)
        verdict(tag, ok and got.dtype == want.dtype,
                f"max_abs_err={err:.3e} (rtol={rtol}, atol={atol})")
        return err

    # -- K5: pack_a / pack_b / pack_b_grouped, byte-equal, on their bodies ----
    k5_fails, k5_seen = k5_checks(torch, dict(pack=pk, tf=tf))
    log(f"  K5 checks, launches by body: {k5_seen}")
    fails += k5_fails
    fmt = tf.TileFormat(bk=128, bn=64, dtype="bfloat16")
    # Empty operands launch nothing and count nothing.
    before = {f.__name__: f.launches for f in (
        gt.gemm_tiled, gv.matmul_vsx_like, gv.matmul_vsx_like_packed)}
    gt.gemm_tiled(randn(0, 64), randn(64, 32))
    gv.matmul_vsx_like(randn(0, 64), randn(64, 32))
    gv.matmul_vsx_like_packed(randn(0, 64), pk.pack_b_plain(randn(64, 32), fmt), 32)
    after = {f.__name__: f.launches for f in (
        gt.gemm_tiled, gv.matmul_vsx_like, gv.matmul_vsx_like_packed)}
    verdict("empty operands count no launch", after == before,
            f"counts {after} (before {before})")

    # -- K7, K6, K8 against their plain versions ------------------------------
    # f32: full f32 on both sides, summed in other orders: 1e-4. bf16 output:
    # both accumulate in f32, then round to bf16 (2^-8 relative): 2e-2.
    # int8 -> int32: exact.
    m, k, n = 37, 300, 200
    a, w, bias, c = randn(m, k), randn(k, n, std=0.05), randn(n), randn(m, n)
    for epi in EPIS:
        check(f"gemm_tiled f32 {epi}+bias {m}x{k}x{n}", gt.gemm_tiled,
              gt.gemm_tiled_plain, (a, w), dict(bias=bias, epilogue=epi, bm=48),
              1e-4, 1e-4)
    strided_a = randn(m, k + 20)[:, 5:k + 5]
    wt = randn(n, k, std=0.05).t()
    for dt, tol in ((torch.float32, (1e-4, 1e-4)), (bf16, (2e-2, 1e-3))):
        nm = "f32" if dt == torch.float32 else "bf16"
        for mm in (4, m, 100):
            aa = randn(mm, k, dtype=dt)
            check(f"gemm_tiled {nm} M={mm} silu+bias", gt.gemm_tiled,
                  gt.gemm_tiled_plain, (aa, w.to(dt)),
                  dict(bias=bias, epilogue="silu"), *tol)
            check(f"gemm_tiled {nm} M={mm} one block (intrinsic)",
                  gt.gemm_tiled, gt.gemm_tiled_plain, (aa, w.to(dt)),
                  dict(single_block=True, c=randn(mm, n), alpha=0.5, beta=2.0),
                  *tol)
        check(f"gemm_tiled {nm} strided A, transposed B, alpha/beta/c",
              gt.gemm_tiled, gt.gemm_tiled_plain,
              (strided_a.to(dt), wt.to(dt)),
              dict(c=c, alpha=1.5, beta=0.5, epilogue="gelu"), *tol)
    ai, wi = randi(33, 200), randi(200, 96)
    ci, bi = randi(33, 96, lo=-1000, hi=1000, dtype=torch.int32), randi(96, dtype=torch.int32)
    check("gemm_tiled int8 -> int32 c+bias (exact)", gt.gemm_tiled,
          gt.gemm_tiled_plain, (ai, wi),
          dict(c=ci, beta=1.0, bias=bi, out_dtype=torch.int32), 0.0, 0.0)
    for la in ("row", "col"):
        for lb in ("row", "col"):
            for nm, aa, ww, tol, bm in (
                    ("f32", a, w, (1e-4, 1e-4), 16),
                    ("bf16", a.to(bf16), w.to(bf16), (2e-2, 1e-3), 64),
                    ("bf16 M=4", randn(4, k, dtype=bf16), w.to(bf16),
                     (2e-2, 1e-3), 16)):
                ap, bp = pk.pack_a_plain(aa, bm, 64, la), pk.pack_b_plain(ww, 64, 32, lb)
                check(f"gemm_packed {nm} A {la} B {lb} tanh+bias c",
                      gp.gemm_packed, gp.gemm_packed_plain,
                      (ap, bp, aa.shape[0], n),
                      dict(c=randn(aa.shape[0], n), alpha=1.5, beta=0.5,
                           bias=bias, epilogue="tanh", layout_a=la,
                           layout_b=lb), *tol)
            check(f"gemm_packed int8 A {la} B {lb} -> int32 (exact)",
                  gp.gemm_packed, gp.gemm_packed_plain,
                  (pk.pack_a_plain(ai, 16, 64, la),
                   pk.pack_b_plain(wi, 64, 32, lb), 33, 96),
                  dict(c=ci, beta=2.0, out_dtype=torch.int32, layout_a=la,
                       layout_b=lb), 0.0, 0.0)
    for epi in EPIS:
        check(f"gemm_packed f32 {epi}+bias", gp.gemm_packed,
              gp.gemm_packed_plain,
              (pk.pack_a_plain(a, 32, 64), pk.pack_b_plain(w, 64, 64), m, n),
              dict(bias=bias, epilogue=epi), 1e-4, 1e-4)
    # K8 widens bf16 to f32 exactly and sums in f32: 1e-4 on both dtypes.
    for nm, aa, ww in (("f32", a, w), ("bf16", a.to(bf16), w.to(bf16))):
        check(f"matmul_vsx_like {nm} -> f32", gv.matmul_vsx_like,
              gv.matmul_vsx_like_plain, (aa, ww),
              dict(out_dtype=torch.float32, bm=32), 1e-4, 1e-4)
        check(f"matmul_vsx_like {nm} strided A, transposed B", gv.matmul_vsx_like,
              gv.matmul_vsx_like_plain, (strided_a.to(aa.dtype), wt.to(aa.dtype)),
              dict(out_dtype=torch.float32), 1e-4, 1e-4)
        for lb in ("row", "col"):
            check(f"matmul_vsx_like_packed {nm} B {lb}", gv.matmul_vsx_like_packed,
                  gv.matmul_vsx_like_packed_plain,
                  (aa, pk.pack_b_plain(ww, 64, 32, lb), n),
                  dict(layout_b=lb, out_dtype=torch.float32), 1e-4, 1e-4)
    check("matmul_vsx_like int8 -> int32 (exact)", gv.matmul_vsx_like,
          gv.matmul_vsx_like_plain, (ai, wi), dict(out_dtype=torch.int32),
          0.0, 0.0)
    check("matmul_vsx_like_packed int8 col -> int32 (exact)",
          gv.matmul_vsx_like_packed, gv.matmul_vsx_like_packed_plain,
          (ai, pk.pack_b_plain(wi, 64, 32, "col"), 96),
          dict(layout_b="col", out_dtype=torch.int32), 0.0, 0.0)
    edge_fails, edge_seen = k6_k8_checks(torch, ks)
    log(f"  K6 / K8 edge checks, launches by body: {edge_seen}")
    fails += edge_fails
    edge_fails, edge_seen = k7_checks(torch, ks)
    log(f"  K7 edge checks, launches by body: {edge_seen}")
    fails += edge_fails
    if fails:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{fails}")

    # -- times at olmo-1b's shapes (bf16), B rotated over >= 128 MB -----------
    rows, main_err = [], {"gemm_tiled": 0.0, "gemm_packed": 0.0,
                          "matmul_vsx_like": 0.0,
                          "matmul_vsx_like_packed": 0.0}
    fmt = tf.TileFormat(bk=128, bn=64, dtype="bfloat16")
    tracked = (gt.gemm_tiled, gp.gemm_packed, gv.matmul_vsx_like,
               gv.matmul_vsx_like_packed)
    for (k, n) in OLMO_SHAPES:
        head = (k, n) == (2048, 50304)
        copies = max(1, min(16, math.ceil(128e6 / (k * n * 2))))
        # The LM head is served as table.t(), a transposed view.
        ws = [randn(n, k, std=0.02, dtype=bf16).t() if head else
              randn(k, n, std=0.02, dtype=bf16) for _ in range(copies)]
        bps = [pk.pack_b(x, fmt) for x in ws]
        # K8's CUDA-core yardstick: the same product in f32 with TF32 off.
        ws32 = [x.float() for x in ws]
        b_bytes = k * n * 2
        for m in (4, 512):
            a = randn(m, k, dtype=bf16)
            bm = min(64, -(-m // 16) * 16)
            ap = pk.pack_a(a, bm, 128)
            before = {f.__name__: dict(f.variants) for f in tracked}
            main_err["gemm_tiled"] = max(main_err["gemm_tiled"], check(
                f"gemm_tiled bf16 M={m} K={k} N={n}", gt.gemm_tiled,
                gt.gemm_tiled_plain, (a, ws[0]), {}, 2e-2, 1e-3))
            main_err["gemm_packed"] = max(main_err["gemm_packed"], check(
                f"gemm_packed bf16 M={m} K={k} N={n}", gp.gemm_packed,
                gp.gemm_packed_plain, (ap, bps[0], m, n), {}, 2e-2, 1e-3))
            main_err["matmul_vsx_like"] = max(main_err["matmul_vsx_like"], check(
                f"matmul_vsx_like bf16 M={m} K={k} N={n} -> f32",
                gv.matmul_vsx_like, gv.matmul_vsx_like_plain, (a, ws[0]),
                dict(out_dtype=torch.float32), 1e-4, 1e-4))
            main_err["matmul_vsx_like_packed"] = max(
                main_err["matmul_vsx_like_packed"], check(
                    f"matmul_vsx_like_packed bf16 M={m} K={k} N={n} -> f32",
                    gv.matmul_vsx_like_packed, gv.matmul_vsx_like_packed_plain,
                    (a, bps[0], n), dict(out_dtype=torch.float32), 1e-4, 1e-4))
            # The new bodies must have run: tc_stream / wgmma for K7 and K6,
            # fma_stream / fma_tiled for K8.
            ran = {f.__name__: [v for v, c in f.variants.items()
                                if c != before[f.__name__][v]] for f in tracked}
            want = {"gemm_tiled": [k7_body(m)], "gemm_packed": [k7_body(m)],
                    "matmul_vsx_like": ["fma_stream" if m <= 16 else "fma_tiled"]}
            want["matmul_vsx_like_packed"] = want["matmul_vsx_like"]
            verdict(f"bodies at M={m} K={k} N={n}", ran == want,
                    f"ran {ran} (want {want})")
            reps = 20 if m == 4 else 5
            lib = time_ms(lambda i: torch.matmul(a, ws[i % copies]), reps)
            lib_dev = device_ms(lambda i: torch.matmul(a, ws[i % copies]), reps)
            a32 = a.float()
            lib_f32 = time_ms(lambda i: torch.matmul(a32, ws32[i % copies]), reps)
            lib_f32_dev = device_ms(lambda i: torch.matmul(a32, ws32[i % copies]), reps)
            for name, fn, plain, peak, a_bytes, out_item in (
                    ("gemm_tiled", lambda i: gt.gemm_tiled(a, ws[i % copies]),
                     lambda i: gt.gemm_tiled_plain(a, ws[i % copies]),
                     H100_BF16_FLOPS, m * k * 2, 2),
                    ("gemm_packed", lambda i: gp.gemm_packed(ap, bps[i % copies], m, n),
                     lambda i: gp.gemm_packed_plain(ap, bps[i % copies], m, n),
                     H100_BF16_FLOPS, ap.numel() * 2, 2),
                    ("matmul_vsx_like",
                     lambda i: gv.matmul_vsx_like(a, ws[i % copies],
                                                  out_dtype=torch.float32),
                     lambda i: gv.matmul_vsx_like_plain(a, ws[i % copies],
                                                        out_dtype=torch.float32),
                     H100_F32_FLOPS, m * k * 2, 4),
                    ("matmul_vsx_like_packed",
                     lambda i: gv.matmul_vsx_like_packed(
                         a, bps[i % copies], n, out_dtype=torch.float32),
                     lambda i: gv.matmul_vsx_like_packed_plain(
                         a, bps[i % copies], n, out_dtype=torch.float32),
                     H100_F32_FLOPS, m * k * 2, 4)):
                vsx = name.startswith("matmul_vsx")
                t_k = time_ms(fn, max(2, reps // 4) if vsx else reps)
                t_dev = device_ms(fn, max(2, reps // 4) if vsx else reps)
                t_p = time_ms(plain, max(2, reps // 4))
                bytes_b = (fmt.packed_bytes(k, n)
                           if name in ("gemm_packed", "matmul_vsx_like_packed")
                           else b_bytes)
                t_b, by = gemm_bound_ms(m, k, n, a_bytes, bytes_b, out_item, peak)
                rows.append(dict(kernel=name, m=m, k=k, n=n, ms=t_k, plain_ms=t_p,
                                 bound_ms=t_b, bound_by=by, library_ms=lib,
                                 device_ms=t_dev, library_device_ms=lib_dev,
                                 variant=ran.get(name),
                                 **({"library_f32_ms": lib_f32,
                                     "library_f32_device_ms": lib_f32_dev}
                                    if vsx else {})))
                log(f"  time {name} M={m} K={k} N={n}: kernel {t_k:.4f} ms "
                    f"(device {t_dev:.4f}), plain {t_p:.4f} ms, torch.matmul "
                    f"{lib:.4f} ms (device {lib_dev:.4f})"
                    + (f" (f32, TF32 off: {lib_f32:.4f} ms, device "
                       f"{lib_f32_dev:.4f})" if vsx else "")
                    + f", bound {t_b:.4f} ms ({by})")
        del ws, ws32, bps
    rows += k7_square_times(torch, gt)
    # K5 at the served paths' shapes, beside torch's one-call copy and its
    # general body.
    k5_rows, k5_fails = k5_times(torch, pk, tf)
    rows += k5_rows
    fails += k5_fails
    for kernel in ("pack_b", "pack_b_grouped"):
        main_err[kernel] = max(r["max_abs_err"] for r in k5_rows if r["kernel"] == kernel)
    if fails:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{fails}")
    return rows, main_err


K7_SQUARE = 4096   # the sweep's largest size (SWEEP_SIZES)


def k7_square_times(torch, gt) -> list:
    """K7 at the sweep's largest bf16 size (4096 cubed, row-major operands)
    as ``tiling`` (the whole card, wgmma) and ``intrinsic`` (one block, so
    one of 132 SMs), each checked against the f32 product (1e-2 of max|C|,
    as phase 4) and timed beside its bound and torch.matmul. Returns the
    timing rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    size = K7_SQUARE
    a, b = (torch.randn((size, size), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    want = torch.matmul(a.float(), b.float())
    t_b, by = gemm_bound_ms(size, size, size, 2 * size * size, 2 * size * size, 2,
                            H100_BF16_FLOPS)
    lib = time_ms(lambda i: torch.matmul(a, b), 10)
    lib_dev = device_ms(lambda i: torch.matmul(a, b), 10)
    rows = []
    for strategy, one, reps in (("tiling", False, 10), ("intrinsic", True, 2)):
        before = dict(gt.gemm_tiled.variants)
        got = gt.gemm_tiled(a, b, single_block=one)
        torch.cuda.synchronize()
        ran = [v for v, c in gt.gemm_tiled.variants.items() if c != before[v]]
        err = float((got.float() - want).abs().max() / want.abs().max())
        if err > 1e-2 or ran != ["wgmma"]:
            raise AssertionError(f"K7 {strategy} bf16 {size}: rel err {err:.2e}, "
                                 f"bodies {ran} (want wgmma)")
        t_k = time_ms(lambda i: gt.gemm_tiled(a, b, single_block=one), reps)
        t_dev = device_ms(lambda i: gt.gemm_tiled(a, b, single_block=one), reps)
        rows.append(dict(kernel="gemm_tiled", strategy=strategy, m=size, k=size,
                         n=size, variant=ran[0], rel_err=err, ms=t_k, device_ms=t_dev,
                         bound_ms=t_b, bound_by=by, library_ms=lib,
                         library_device_ms=lib_dev))
        log(f"  time gemm_tiled {strategy} bf16 {size}^3 ({ran[0]}"
            f"{', one block' if one else ''}): kernel {t_k:.4f} ms (device "
            f"{t_dev:.4f}), torch.matmul {lib:.4f} ms (device {lib_dev:.4f}), "
            f"bound {t_b:.4f} ms ({by}); rel err {err:.2e}")
    return rows


TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA")


# The SASS of each library dumped so far, by path (``dump_all_sass``);
# emptied once phase 1's SASS checks are done.
SASS_CACHE = {}


def dump_all_sass(paths) -> None:
    """Dump the SASS of every library of ``paths`` not dumped yet into
    SASS_CACHE, one cuobjdump process each, all started together: one
    after another they were most of phase 1 (``tools/smoke_phase_times.py``
    times it). Without cuobjdump the checks cannot be made, and the run
    fails."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise AssertionError("cuobjdump not found: cannot read the kernels' "
                             "SASS")
    todo = [str(p) for p in paths if str(p) not in SASS_CACHE]

    def dump(path):
        return subprocess.run([tool, "--dump-sass", path], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        for path, sass in zip(todo, pool.map(dump, todo)):
            SASS_CACHE[path] = sass


def dump_sass(path) -> str:
    """The SASS of a built library (``dump_all_sass``)."""
    dump_all_sass([path])
    return SASS_CACHE[str(path)]


def tensor_core_ops(path) -> tuple:
    """(tensor-core opcodes found, SASS line count) of a built library."""
    sass = dump_sass(path)
    return ({op for op in TENSOR_CORE_OPS if op in sass},
            len(sass.splitlines()))


def sass_by_function(path, find=None) -> dict:
    """{kernel function (mangled name): the opcodes ``find(line)`` picks
    from its SASS lines (by default the tensor-core ones)}."""
    if find is None:
        def find(line):
            return [op for op in TENSOR_CORE_OPS if op in line]
    funcs, name = {}, None
    for line in dump_sass(path).splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = set()
        elif name is not None:
            funcs[name].update(find(line))
    return funcs


# K1's CUDA-core kernel functions, by a piece of their names: the f32 /
# int8 bodies and the split reduction (no tensor-core instruction), and its
# wgmma body (HGMMA).
K1_CORE_FUNCTIONS = ("fma_tiled", "fma_stream", "fused_a_fma", "splitk_reduce")


def check_k1_sass(path) -> str:
    """K1's library holds its bf16 tensor-core bodies too, so the check is
    per function: every CUDA-core function (fma_tiled, fma_stream, the f32
    / int8 bodies, and the split reduction) issues no HMMA / HGMMA / IMMA,
    and every wgmma_packed function issues HGMMA."""
    funcs = sass_by_function(path)
    core = {n: ops for n, ops in funcs.items()
            if any(t in n for t in K1_CORE_FUNCTIONS)}
    wg = {n: ops for n, ops in funcs.items() if "wgmma_packed" in n}
    missing = [t for t in K1_CORE_FUNCTIONS if not any(t in n for n in core)]
    bad = sorted(n for n, ops in core.items() if ops)
    if missing or bad or not wg or not all("HGMMA" in ops for ops in wg.values()):
        raise AssertionError(f"{path.name}: CUDA-core functions missing "
                             f"{missing}, with tensor-core ops {bad}; wgmma "
                             f"functions {len(wg)} "
                             f"{sorted(set().union(*wg.values())) if wg else []}")
    return (f"{len(core)} CUDA-core functions without HMMA/HGMMA/IMMA, "
            f"{len(wg)} wgmma functions with HGMMA, of {len(funcs)}")


def check_sass_functions(path, want, core) -> str:
    """A library's SASS per function: every function whose name holds a tag
    of ``want`` issues that tag's opcode, every one whose name holds a tag
    of ``core`` issues no tensor-core op, and each tag names at least one
    function."""
    funcs = sass_by_function(path)
    found = {tag: [ops for n, ops in funcs.items() if tag in n] for tag in
             (*want, *core)}
    bad = [tag for tag, op in want.items()
           if not found[tag] or not all(op in ops for ops in found[tag])]
    bad += [tag for tag in core if not found[tag] or any(found[tag])]
    if bad:
        raise AssertionError(f"{path.name}: functions failing their SASS "
                             f"check {bad}: " + ", ".join(
                                 f"{tag} {[sorted(o) for o in ops]}"
                                 for tag, ops in found.items()))
    return ", ".join(f"{len(ops)} {tag} ({want.get(tag, 'no tensor-core op')})"
                     for tag, ops in found.items()) + f", of {len(funcs)}"


def check_grouped_sass(path) -> str:
    """K2 / K3's library, per function: HGMMA in every grouped_wgmma, HMMA
    in every grouped_stream (mma.sync over the TMA ring), no tensor-core
    op in grouped_fma (f32 in full f32, int8 on i32) or grouped_reduce."""
    return check_sass_functions(path, {"grouped_wgmma": "HGMMA", "grouped_stream": "HMMA"},
                                ("grouped_fma", "grouped_reduce"))


# The quantized TMA bodies' functions, by a piece of their names, and the
# opcodes each must issue: a TMA load and mma.sync at decode, a TMA load
# and wgmma at prefill.
QUANT_SASS = {"gemm_packed_fused_a": {"quant_stream": ("UTMALDG", "HMMA"),
                                      "quant_wgmma": ("UTMALDG", "HGMMA")},
              "gemm_grouped_packed": {"grouped_quant_stream": ("UTMALDG", "HMMA"),
                                      "grouped_quant_wgmma": ("UTMALDG", "HGMMA")}}


def check_quant_sass(path, want) -> str:
    """Per function of a library: every function whose name holds a tag of
    ``want`` issues each of its opcodes (whatever their suffixes), and each
    tag names at least one function."""
    import re
    funcs = sass_by_function(path, lambda line: re.findall(
        r"\b(?:HMMA|HGMMA|IMMA|UTMALDG)\b", line))
    found = {tag: [ops for n, ops in funcs.items() if tag in n] for tag in want}
    bad = [tag for tag, ops in found.items()
           if not ops or not all(op in o for o in ops for op in want[tag])]
    if bad:
        raise AssertionError(f"{path.name}: quantized functions failing their "
                             f"SASS check {bad}: {found}")
    return ", ".join(f"{len(ops)} {tag} ({'+'.join(want[tag])})"
                     for tag, ops in found.items())


def check_k7_sass(path) -> str:
    """K7's library, per function: HGMMA in every wgmma_packed (its wgmma
    body), HMMA in every mma_stream (tc_stream: mma.sync over the TMA ring),
    no tensor-core op in its CUDA-core bodies (f32 in full f32, int8 on i32)
    or the split reduction."""
    return check_sass_functions(path, {"wgmma_packed": "HGMMA", "mma_stream": "HMMA"},
                                ("fma_tiled", "fma_stream", "splitk_reduce"))


def check_k4_sass(path) -> str:
    """K4's library, per function: HGMMA in every flash_wgmma_kernel (the
    wgmma body), HMMA in every flash_stream_kernel (stream: mma.sync over
    the TMA ring) and flash_mma_kernel (mma_general), no tensor-core op in
    flash_f32_kernel (f32 in full f32)."""
    return check_sass_functions(path, {"flash_wgmma_kernel": "HGMMA",
                                       "flash_stream_kernel": "HMMA",
                                       "flash_mma_kernel": "HMMA"},
                                ("flash_f32_kernel",))


def check_no_tensor_cores(path) -> str:
    """The SASS of the built K8 library holds no tensor-core instruction
    (HMMA / HGMMA / IMMA); returns what was checked."""
    found, lines = tensor_core_ops(path)
    if found:
        raise AssertionError(f"{path.name} issues tensor-core instructions "
                             f"{sorted(found)}")
    return f"no HMMA/HGMMA/IMMA in {lines} SASS lines"


def check_wgmma(path) -> str:
    """The SASS of the built K6 library holds HGMMA (wgmma)."""
    found, lines = tensor_core_ops(path)
    if "HGMMA" not in found:
        raise AssertionError(f"{path.name} issues no HGMMA ({sorted(found)})")
    return f"{sorted(found)} in {lines} SASS lines"


# K4 checks, (B, Sq, Skv, H, Hkv, D, causal, window): the reference test's
# CASES (tests/test_flash_attention.py), then Sq > Skv (rows that see no
# key), a window without causal, D = 128 and 256, mixtral's GQA at decode,
# and head dims that are no multiple of 8 (element-wise loads, not cp.async).
ATTN_CASES = [
    (2, 128, 128, 4, 2, 32, True, None), (1, 100, 100, 4, 4, 16, True, None),
    (2, 64, 64, 4, 1, 32, True, 24), (1, 1, 96, 4, 2, 16, True, None),
    (2, 48, 48, 2, 2, 16, False, None), (1, 37, 111, 3, 1, 8, True, None),
    (1, 50, 20, 2, 1, 8, True, None), (2, 70, 40, 4, 2, 128, True, 9),
    (1, 33, 90, 6, 2, 128, False, 17), (2, 130, 130, 4, 4, 128, True, None),
    (1, 65, 65, 2, 1, 256, True, None), (1, 20, 300, 3, 3, 200, True, 50),
    (3, 1, 1000, 48, 8, 128, True, 300), (1, 40, 60, 4, 2, 37, True, None),
    (2, 30, 30, 2, 2, 1, False, None)]
# K4 against its plain version, (rtol, atol, max_norm) for
# attention_close. f32:
# full f32 on both sides, other summation orders. bf16 / f16: the kernel
# rounds P to the input type for the PV product and the output once; the
# plain version keeps P in f32. In bf16 that costs about 2e-3 of the
# output's norm and at most about a third of an element's limit (below) at
# the shapes of phases 1 and 6 (a CPU model of the kernel's arithmetic).
ATTN_TOL = {"float32": (2e-4, 2e-4, 2e-4), "bfloat16": (2e-2, 1e-2, 1e-2),
            "float16": (2e-2, 1e-2, 1e-2)}
# The uniform-weight probe of phase 6: with q = 0 every score is 0 and every
# weight exactly 1 on both sides, so both add the same bf16 V rows in f32
# and differ by output rounding only. One key more or less at 32k keys
# moves the output's norm by 1/sqrt(32768) = 5.5e-3.
ATTN_PROBE_TOL = (1e-2, 1e-3, 1e-3)


def attention_close(got, want, rtol, atol, max_norm):
    """K4's output against its plain version's: every element within
    ``rtol * |want| + min(atol, rtol * scale)``, and the error's norm within
    ``max_norm`` of the reference's. ``scale`` is the larger of the RMS of
    the element's row (one query and head, over D) and the RMS of all of
    ``want``: a limit scaled to the reference, whose rows differ in size by
    the keys they see (an RMS of about sqrt(e / keys) for unit-normal
    inputs, 0.009 at 32k keys, 1 at one key), and never above the plain
    ``rtol * |want| + atol``. Returns (ok, max abs error, normwise error,
    what failed: "element", "norm", both or "")."""
    import torch
    w = want.float()
    err = (got.float() - w).abs()
    scale = torch.maximum(w.pow(2).mean(-1, keepdim=True).sqrt(),
                          w.pow(2).mean().sqrt())
    limit = rtol * w.abs() + torch.clamp(rtol * scale, max=atol)
    failed = [] if bool(torch.all(err <= limit)) else ["element"]
    w_norm = float(torch.linalg.vector_norm(w))
    norm = float(torch.linalg.vector_norm(err)) / w_norm if w_norm else float(
        err.max() > 0)
    if norm > max_norm:
        failed.append("norm")
    return not failed, float(err.max()), norm, "+".join(failed)


# K4 at its bodies' edges, (B, Sq, Skv, H, Hkv, D, causal, window), in bf16
# and f16: Sq * group at 1, 6, 12, 16, 17 and 18 rows around the stream
# body's limit (mixtral's 48 / 8 heads and H = Hkv); prefill with Sq off
# the 128-row tile; Skv off the key tile; Sq < Skv at prefill width, causal
# and windowed; windows whose lower edge falls on a tile edge, one key off
# it either way, and without causal; D 64 / 128 on wgmma, 256 on
# mma_general; many query heads of one KV head at prefill.
ATTN_EDGE_CASES = [
    (2, 1, 300, 48, 8, 128, True, None), (2, 2, 300, 48, 8, 128, True, None),
    (1, 3, 300, 48, 8, 128, True, 100), (2, 1, 200, 4, 4, 128, True, None),
    (1, 6, 200, 4, 4, 128, True, None), (1, 12, 200, 4, 4, 64, True, 50),
    (1, 16, 200, 4, 4, 128, True, None), (1, 17, 200, 4, 4, 128, True, None),
    (1, 18, 200, 2, 2, 64, False, None), (1, 8, 150, 8, 4, 128, True, None),
    (1, 9, 150, 8, 4, 128, True, None), (1, 300, 300, 4, 2, 128, True, None),
    (2, 200, 200, 2, 1, 64, True, None), (1, 256, 333, 4, 4, 128, True, None),
    (1, 100, 1000, 4, 4, 128, True, None), (1, 100, 1000, 4, 4, 128, True, 200),
    (1, 512, 512, 2, 2, 128, True, 128), (1, 512, 512, 2, 2, 128, True, 129),
    (1, 512, 512, 2, 2, 128, True, 127), (1, 256, 256, 2, 1, 64, False, 128),
    (2, 1, 1024, 8, 8, 128, True, 64), (2, 1, 1024, 8, 8, 128, True, 65),
    (1, 130, 130, 2, 2, 256, True, None), (1, 1000, 1000, 12, 2, 128, True, None),
    (1, 700, 700, 6, 1, 64, False, None)]


def phase_attention_checks(torch, fa):
    """K4 against its plain version on the card at ``ATTN_CASES`` in f32,
    bf16 and f16, at ``ATTN_EDGE_CASES`` in bf16 and f16, on strided views
    of a fused qkv tensor (prefill and decode, D 64 and 128), on q / k / v
    whose heads are stored outside the sequence (a transposed [B, H, S, D])
    and on a q offset by one element. Every call must take the body
    ``attention_body`` names (read from ``flash_attention.variants``).
    Rows that see no key must be exactly 0; an empty output counts no
    launch. Returns the max abs error by dtype."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    fails, errs = [], {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    def check(tag, q, k, v, causal, window, dtype):
        rtol, atol, max_norm = ATTN_TOL[dtype]
        body = fa.attention_body(q, k, v, causal, window)
        before = dict(fa.flash_attention.variants)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ran = [b for b, c in fa.flash_attention.variants.items() if c != before[b]]
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        ok, err, norm, _ = attention_close(got, want, rtol, atol, max_norm)
        dead = q.shape[1] - k.shape[1] if causal else 0
        zero = dead <= 0 or bool((got[:, :dead] == 0).all())
        ok = (ok and zero and got.dtype == q.dtype and ran == [body]
              and bool(torch.isfinite(got).all()))
        errs[dtype] = max(errs.get(dtype, 0.0), err)
        log(f"  check flash_attention {tag} ({'/'.join(ran)}, want {body}): "
            f"max_abs_err={err:.3e}, norm "
            f"{norm:.2e} (rtol={rtol}, atol={atol} or less, norm <= {max_norm})"
            f"{'; unseen rows 0' if dead > 0 else ''} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(tag)

    def case(name, b, sq, skv, h, hkv, d, causal, window):
        dt = getattr(torch, name)
        check(f"{name} B={b} Sq={sq} Skv={skv} H={h}/{hkv} D={d} "
              f"causal={causal} window={window}",
              randn(b, sq, h, d, dtype=dt), randn(b, skv, hkv, d, dtype=dt),
              randn(b, skv, hkv, d, dtype=dt), causal, window, name)

    for name in ATTN_TOL:
        for shape in ATTN_CASES:
            case(name, *shape)
    for name in ("bfloat16", "float16"):
        for shape in ATTN_EDGE_CASES:
            case(name, *shape)
    qkv = randn(2, 77, 3, 4, 64)   # [B, S, (q k v), H, D]
    check("bfloat16 strided views of a fused qkv", qkv[:, :, 0], qkv[:, :, 1],
          qkv[:, :, 2], True, None, "bfloat16")
    for s_len, d in ((77, 128), (1, 64), (1, 128)):
        qkv = randn(2, s_len, 3, 8, d)
        check(f"bfloat16 strided views of a fused qkv, S={s_len} D={d}",
              qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True, None, "bfloat16")
    for sq, h in ((40, 8), (2, 8)):   # [B, H, S, D] storage read as [B, S, H, D]
        q = randn(1, h, sq, 128).transpose(1, 2)
        kv = randn(2, 2, 60, 128)
        check(f"bfloat16 heads outside the sequence, Sq={sq} H={h}/2", q,
              kv[0:1].transpose(1, 2), kv[1:2].transpose(1, 2), True, None,
              "bfloat16")
    buf = randn(1 + 2 * 64 * 4 * 128)
    check("bfloat16 q offset by one element", buf[1:].view(2, 64, 4, 128),
          randn(2, 64, 4, 128), randn(2, 64, 4, 128), True, None, "bfloat16")
    before = fa.flash_attention.launches
    empty = torch.empty((0, 4, 2, 16), device=DEVICE)
    fa.flash_attention(empty, empty, empty)
    if fa.flash_attention.launches != before:
        fails.append("empty output counted a launch")
    if fails:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {fails}")
    return errs


def phase_ops_checks(torch, ops, counters, ks):
    """Each ``repro_torch.kernels.ops`` wrapper once at a small odd shape on
    the card against the plain composition of what it launches, with its
    launches counted (set to 0 just before the call, read just after).
    Returns the counts by wrapper."""
    pk, gp, gt, gv, gg, fa = (ks[x] for x in ("pack", "gp", "gt", "gv", "gg", "fa"))
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE) * std).to(dtype)

    m, k, n, e = 37, 300, 200, 3
    a, w, c, bias = randn(m, k), randn(k, n, std=0.05), randn(m, n), randn(n)
    ab, wb = a.to(bf16), w.to(bf16)
    ag = randn(e, m, k, dtype=bf16)
    wg, wg2 = randn(e, k, n, std=0.05, dtype=bf16), randn(e, k, n, std=0.05, dtype=bf16)
    bg = randn(e, n)
    q, kk, vv = (randn(2, 45, 6, 64, dtype=bf16), randn(2, 90, 2, 64, dtype=bf16),
                 randn(2, 90, 2, 64, dtype=bf16))
    f32_tol, bf16_tol = (1e-4, 1e-4), (2e-2, 1e-3)
    cases = [
        ("tiled_matmul", lambda: ops.tiled_matmul(a, w, c, alpha=1.5, beta=0.5, bm=48),
         lambda: gt.gemm_tiled_plain(a, w, c, alpha=1.5, beta=0.5), f32_tol,
         {"gemm_tiled": 1}),
        ("packed_matmul", lambda: ops.packed_matmul(
            ab, wb, c, bm=64, bk=64, bn=32, layout_a="col", alpha=0.5, beta=2.0),
         lambda: gp.gemm_packed_plain(
             pk.pack_a_plain(ab, 64, 64, "col"), pk.pack_b_plain(wb, 64, 32), m, n,
             c, alpha=0.5, beta=2.0, layout_a="col"), bf16_tol,
         {"pack_a": 1, "pack_b": 1, "gemm_packed": 1}),
        ("packed_matmul_fused", lambda: ops.packed_matmul_fused(
            ab, wb, bias=bias, bm=48, bk=64, bn=64, epilogue="gelu"),
         lambda: gp.gemm_packed_fused_a_plain(
             ab, pk.pack_b_plain(wb, 64, 64), n, bias=bias, bm=48,
             epilogue="gelu"), bf16_tol,
         {"pack_b": 1, "gemm_packed_fused_a": 1}),
        ("grouped_matmul_packed", lambda: ops.grouped_matmul_packed(
            ag, wg, b2=wg2, bias=bg, bm=48, bk=64, bn=64, epilogue="silu_gate"),
         lambda: gg.gemm_grouped_packed_plain(
             ag, pk.pack_b_grouped_plain(wg, 64, 64), n,
             b2_packed=pk.pack_b_grouped_plain(wg2, 64, 64), bias=bg, bm=48,
             epilogue="silu_gate"), bf16_tol,
         {"pack_b_grouped": 2, "gemm_grouped_packed": 1}),
        ("vsx_matmul", lambda: ops.vsx_matmul(a, w, bm=32),
         lambda: gv.matmul_vsx_like_plain(a, w), f32_tol, {"matmul_vsx_like": 1}),
        ("attention", lambda: ops.attention(q, kk, vv, causal=True, window=40),
         lambda: fa.flash_attention_plain(q, kk, vv, causal=True, window=40),
         lambda g, w: attention_close(g, w, *ATTN_TOL["bfloat16"])[:2],
         {"flash_attention": 1}),
        ("pack_a_op", lambda: ops.pack_a_op(ab, 32, 64, "col"),
         lambda: pk.pack_a_plain(ab, 32, 64, "col"), None, {"pack_a": 1}),
        ("pack_b_op", lambda: ops.pack_b_op(wb, 64, 32),
         lambda: pk.pack_b_plain(wb, 64, 32), None, {"pack_b": 1}),
        ("pack_b_grouped_op", lambda: ops.pack_b_grouped_op(wg, 64, 32, "col"),
         lambda: pk.pack_b_grouped_plain(wg, 64, 32, "col"), None,
         {"pack_b_grouped": 1}),
    ]
    fails, counts = [], {}
    for name, fn, plain, tol, want in cases:
        counters.reset()
        got = fn()
        torch.cuda.synchronize()
        launches = counters.read()
        counts[name] = {kname: c for kname, c in launches.items() if c}
        exp = plain()
        if tol is None:
            ok, detail = same_bytes(torch, got, exp), "byte-equal"
        elif callable(tol):
            ok, err = tol(got, exp)
            detail = f"max_abs_err={err:.3e} (attention_close)"
        else:
            ok, err = close(got, exp, *tol)
            detail = f"max_abs_err={err:.3e} (rtol={tol[0]}, atol={tol[1]})"
        ok = ok and launches == counters.only(**want)
        log(f"  check ops.{name}: {detail}; launches {counts[name]} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(name)
    if fails:
        raise AssertionError(f"ops wrappers disagree with their plain "
                             f"compositions or launched other kernels: {fails}")
    return counts


SWEEP_SIZES = SMALL_SIZES + MEDIUM_SIZES + LARGE_SIZES  # the paper's §4 grid
SWEEP_CAP = {"naive": 512, "pluto": 512, "intrinsic": 2048}

# Kernel launches of one call of each dense strategy.
STRATEGY_LAUNCHES = {
    "intrinsic": {"gemm_tiled": 1}, "tiling": {"gemm_tiled": 1},
    "tiling_packing": {"pack_a": 1, "pack_b": 1, "gemm_packed": 1},
    "tiling_packing_fused": {"pack_b": 1, "gemm_packed_fused_a": 1},
    "vsx": {"matmul_vsx_like": 1}}


# Positions of the split count and the grid cap in K7's argument tuple
# (gemm_tiled.py _ARGTYPES).
K7_SPLITS_ARG, K7_MAX_BLOCKS_ARG = 21, 24


def one_block(a, b) -> tuple:
    """(grid cap, splits) that K7's launch_args give an intrinsic call."""
    import torch
    from repro_torch.kernels import gemm_tiled as gt
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    args, _, _ = gt.launch_args(a, b, None, alpha=1.0, beta=0.0, out=out,
                                epilogue="none", bias=None, single_block=True,
                                stream=None)
    return args[K7_MAX_BLOCKS_ARG], args[K7_SPLITS_ARG]


def phase_sweep(torch, counters, gemm, strategy, ref):
    """The paper's comparison on the card: square GEMMs at the paper's
    sizes, f32 and bf16, through ``gemm.matmul(..., strategy=s)`` for every
    strategy and ``auto``, each output against the f32 product; then the
    grouped lowerings on raw expert stacks. The counted pass runs each case
    once; times are taken after it. Returns (launches, rows, grouped rows)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for size in SWEEP_SIZES:
            a = torch.randn((size, size), generator=gen, device=dev).to(dt)
            b = torch.randn((size, size), generator=gen, device=dev).to(dt)
            for s in ("auto",) + strategy.STRATEGIES:
                if size <= SWEEP_CAP.get(s, size):
                    cases.append((dt, size, s, a, b))
    # Grouped: a gate/up pair of raw [E, K, N] stacks, E=8, 64 rows each.
    e, cap, kg, ng = 8, 64, 1024, 1024
    xg = torch.randn((e, cap, kg), generator=gen, device=dev).to(torch.bfloat16)
    wg = (torch.randn((e, kg, ng), generator=gen, device=dev) * 0.03).to(torch.bfloat16)
    wu = (torch.randn((e, kg, ng), generator=gen, device=dev) * 0.03).to(torch.bfloat16)
    counts = torch.tensor([64, 0, 17, 64, 40, 3, 64, 25], dtype=torch.int32,
                          device=dev)
    gcases = [("grouped_einsum", False), ("grouped_packed", False),
              ("grouped_packed_ragged", True), ("auto", True), ("auto", False)]

    def grouped_call(s, with_counts):
        from repro_torch.core.contraction import ContractionSpec
        from repro_torch.core.epilogue import EPILOGUE_SPECS
        spec = ContractionSpec.grouped(e, cap, kg, ng, torch.bfloat16, w=wg,
                                       epilogue=EPILOGUE_SPECS["silu_gate"],
                                       counts=with_counts)
        return gemm.contract(spec, xg, wg, w2=wu, strategy=s,
                             counts=counts if with_counts else None)

    # -- the counted pass ----------------------------------------------------
    want = {}
    outs = []
    counters.reset()
    bodies = []  # the GEMM bodies each case launched (K5's are logged apart)
    for dt, size, s, a, b in cases:
        before = counters.variants()
        outs.append(gemm.matmul(a, b, strategy=s))
        bodies.append(sorted(f"{name}:{v}" for name, vs in counters.variants().items()
                             for v, c in vs.items()
                             if c != before[name][v] and not name.startswith("pack")))
    gouts = [grouped_call(s, wc) for s, wc in gcases]
    torch.cuda.synchronize()
    launches = counters.read()
    variants = counters.variants()
    expect = {name: 0 for name in launches}
    for dt, size, s, a, b in cases:
        eff = s if s != "auto" else gemm.resolve_strategy(
            size, size, size, dt, on_card=True)
        for name, cnt in STRATEGY_LAUNCHES.get(eff, {}).items():
            expect[name] += cnt
    for s, wc in gcases:
        eff = {("auto", True): "grouped_packed_ragged",
               ("auto", False): "grouped_packed"}.get((s, wc), s)
        if eff != "grouped_einsum":
            expect["pack_b_grouped"] += 2
            expect["gemm_grouped_packed_ragged" if wc else "gemm_grouped_packed"] += 1
    log(f"  sweep launches {launches} (want {expect})")
    if launches != expect:
        raise AssertionError(f"sweep launch counts {launches} != {expect}")
    # From 256 up, tiling (K7) and tiling_packing (K6) take wgmma (bf16) /
    # fma_tiled (f32), tiling_packing_fused (K1) wgmma / fma_tiled, and vsx
    # fma_tiled; at f32 K1 runs on the CUDA-core bodies at every size;
    # intrinsic (K7 as one block) takes a TMA body at every bf16 size.
    k5 = {name: {v: c for v, c in variants[name].items() if c}
          for name in ("pack_a", "pack_b", "pack_b_grouped")}
    log(f"  sweep launches by body {variants}; K5's {k5}")
    wrong = []
    for (dt, size, s, a, b), ran in zip(cases, bodies):
        eff = s if s != "auto" else gemm.resolve_strategy(
            size, size, size, dt, on_card=True)
        bf = dt == torch.bfloat16
        if eff == "intrinsic" and bf:
            one = one_block(a, b)
            if ran != [f"gemm_tiled:{k7_body(size)}"] or one != (1, 1):
                wrong.append((str(dt), size, s, ran, f"gemm_tiled:{k7_body(size)}, "
                              f"(grid, splits) {one} (want (1, 1))"))
        body = {"tiling": ["gemm_tiled:wgmma" if bf else "gemm_tiled:fma_tiled"],
                "tiling_packing": ["gemm_packed:wgmma" if bf
                                   else "gemm_packed:fma_tiled"],
                "tiling_packing_fused": ["gemm_packed_fused_a:wgmma" if bf
                                         else "gemm_packed_fused_a:fma_tiled"],
                "vsx": ["matmul_vsx_like:fma_tiled"]}.get(eff)
        if size >= 256 and body is not None and ran != body:
            wrong.append((str(dt), size, s, ran, body))
        if eff == "tiling_packing_fused" and not bf and ran not in (
                ["gemm_packed_fused_a:fma_tiled"], ["gemm_packed_fused_a:fma_stream"]):
            wrong.append((str(dt), size, s, ran, "K1 on fma_tiled / fma_stream"))
    if wrong:
        raise AssertionError(f"sweep cases did not take the new bodies: "
                             f"{wrong}")
    log("  intrinsic bf16: one block, unsplit, on tc_stream (16) / wgmma (32 up)")

    # -- checks against the f32 product --------------------------------------
    # Error relative to the output's scale (max |C|): f32 outputs 1e-4
    # (full-f32 sums in other orders over K <= 4096); bf16 outputs 1e-2 (the
    # same inputs, f32 sums, one rounding to bf16: 2^-9 of each element).
    rows, fails = [], []
    for (dt, size, s, a, b), out in zip(cases, outs):
        key = (dt, size)
        if key not in want:
            want[key] = torch.matmul(a.float(), b.float())
        w_ = want[key]
        err = float((out.float() - w_).abs().max() / w_.abs().max())
        lim = 1e-4 if dt == torch.float32 else 1e-2
        ok = err <= lim and out.dtype == dt and out.shape == w_.shape
        if not ok:
            fails.append((str(dt), size, s, err))
        rows.append(dict(dtype=str(dt).replace("torch.", ""), size=size,
                         strategy=s, rel_err=err))
    gref = ref.grouped_ragged_ref(xg[:, None], wg, counts[:, None], b2=wu,
                                  out_dtype=torch.float32)[:, 0]
    gfull = ref.grouped_ragged_ref(xg[:, None], wg,
                                   torch.full_like(counts, cap)[:, None],
                                   b2=wu, out_dtype=torch.float32)[:, 0]
    grows = []
    # The gate pair's bf16 output against the f32 pair: the kernels round
    # once (2^-9 of an element), the einsum rounds both products to bf16
    # before silu(gate) * up as well: 2e-2 of max|C|.
    for (s, wc), out in zip(gcases, gouts):
        w_ = gref if wc else gfull
        err = float((out.float() - w_).abs().max() / w_.abs().max())
        if err > 2e-2:
            fails.append(("grouped", s, wc, err))
        grows.append(dict(strategy=s, counts=wc, rel_err=err))
    if fails:
        raise AssertionError(f"sweep outputs disagree with the f32 product: "
                             f"{fails}")
    del outs, gouts, want

    # -- times (uncounted) -----------------------------------------------------
    def timed(fn):
        fn(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(0)
        torch.cuda.synchronize()
        once = time.perf_counter() - t0
        return time_ms(fn, max(1, min(20, int(0.05 / max(once, 1e-6)))))
    lib = {}
    for row, (dt, size, s, a, b) in zip(rows, cases):
        row["ms"] = timed(lambda i: gemm.matmul(a, b, strategy=s))
        if (dt, size) not in lib:
            lib[(dt, size)] = timed(lambda i: torch.matmul(a, b))
        row["library_ms"] = lib[(dt, size)]
    for grow, (s, wc) in zip(grows, gcases):
        grow["ms"] = timed(lambda i: grouped_call(s, wc))
    # tiling_packing without its two per-call packs: K6 alone on the
    # planner's packed operands (uncounted).
    from repro_torch.core.planner import plan_gemm
    from repro_torch.kernels import gemm_packed as gp
    from repro_torch.kernels import pack as pk
    k6_alone = {}
    for dt, size, s, a, b in cases:
        if s != "tiling_packing" or size < 1024:
            continue
        plan = plan_gemm(size, size, size, str(dt).replace("torch.", ""))
        ap = pk.pack_a(a, plan.bm, plan.bk, layout=plan.layout_a)
        bp = pk.pack_b(b, plan.bk, plan.bn, layout=plan.layout_b)
        k6_alone[(str(dt).replace("torch.", ""), size)] = timed(
            lambda i: gp.gemm_packed(ap, bp, size, size, layout_a=plan.layout_a,
                                     layout_b=plan.layout_b))
        del ap, bp
    for row in rows:
        if row["strategy"] == "tiling_packing":
            row["gemm_packed_alone_ms"] = k6_alone.get((row["dtype"], row["size"]))
    for dt in ("float32", "bfloat16"):
        log(f"  sweep {dt} (ms; rel err <= {1e-4 if dt == 'float32' else 1e-2}"
            f" of max|C| against the f32 product):")
        for size in SWEEP_SIZES:
            rs = [r for r in rows if r["dtype"] == dt and r["size"] == size]
            kernel_rows = [r for r in rs if r["strategy"] not in ("auto", "torch_matmul")]
            best = min(kernel_rows, key=lambda r: r["ms"])
            auto = gemm.resolve_strategy(size, size, size, dt, on_card=True)
            for r in rs:
                r["winner"] = best["strategy"]
            alone = k6_alone.get((dt, size))
            log(f"    {size:5d}: " + ", ".join(
                f"{r['strategy']} {r['ms']:.4f}" for r in rs)
                + f"; torch.matmul {rs[0]['library_ms']:.4f}; winner "
                f"{best['strategy']}; auto -> {auto}"
                + (f"; K6 alone (tiling_packing without its packs) {alone:.4f}"
                   if alone is not None else ""))
    log("  grouped E=8 C=64 K=N=1024 bf16 silu-gate pair (ms): " + ", ".join(
        f"{g['strategy']}{'+counts' if g['counts'] else ''} {g['ms']:.4f} "
        f"(err {g['rel_err']:.1e})" for g in grows))
    return launches, rows, grows, variants


# The margin profile_kernels spins for before and after the profiled
# calls: about 10 ms of an H100's clock.
PROFILE_MARGIN_CYCLES = 20_000_000


def profile_kernels(torch, fn, reps, counts=None, warm=True) -> tuple:
    """torch.profiler (CUPTI) over ``reps`` calls of ``fn(i)``, after one
    unprofiled call (none with ``warm=False``): ({kernel name: device us
    summed over the calls}, the
    kernel records it kept against the launch calls it saw on the host,
    "kept / launched" (a lost record would read as idle), the profiled
    wall ms a call). Only the device's own records count: a host op's
    ``self_device_time_total`` is the time of the kernels it launched,
    which have records of their own (summing both counted an aten op's
    kernels twice). ``counts``, a dict, gets {kernel name: records}."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # A spin kernel before and after the calls: the profiler drops a
        # device record that falls outside its window on the host's clock,
        # and the two clocks drift apart over a long process (late in the
        # smoke a replay's profile read one record short, three times).
        torch.cuda._sleep(PROFILE_MARGIN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda._sleep(PROFILE_MARGIN_CYCLES)
        torch.cuda.synchronize()
    dev, records, launched = {}, 0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if "spin_kernel" in ev.key:
            continue
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            if t > 0:
                dev[ev.key] = t
                if not ev.key.startswith(("Memcpy", "Memset")):
                    records += ev.count
                    if counts is not None:
                        counts[ev.key] = counts.get(ev.key, 0) + ev.count
            continue
        if "LaunchKernel" in ev.key:
            launched += ev.count
    launched = max(launched - 2, 0)   # the two spin kernels
    kept = f"{records}/{launched}" if launched else f"{records}/not seen"
    return dev, kept, wall_ms


# What a replay launched, read from its kernel records. Each kernel of the
# port's sources is named here by its ``__global__`` function (K1's, K6's
# and K7's TMA templates also by where A's and B's boxes come from) with
# the (wrapper, body) pairs whose launches issue it, one record a launch.
# Pairs of two wrappers that share a kernel (gemm_blocked.cuh's bodies, K2
# and K3, the three packers) are one class. A split body's reduction is a
# second kernel of the same launch, not a launch of its own.
_BLOCKED = ("gemm_packed_fused_a", "gemm_tiled", "gemm_packed")
_VSX = ("matmul_vsx_like", "matmul_vsx_like_packed")
_GROUPED = ("gemm_grouped_packed_ragged", "gemm_grouped_packed")
_PACKS = ("pack_a", "pack_b", "pack_b_grouped")
KERNEL_CLASSES = {
    "mma_stream NaturalA PackedB": [("gemm_packed_fused_a", "tc_stream")],
    "wgmma_packed NaturalA PackedB": [("gemm_packed_fused_a", "wgmma")],
    "mma_stream NaturalA NaturalB": [("gemm_tiled", "tc_stream")],
    "wgmma_packed NaturalA NaturalB": [("gemm_tiled", "wgmma")],
    "mma_stream PackedA PackedB": [("gemm_packed", "tc_stream")],
    "wgmma_packed PackedA PackedB": [("gemm_packed", "wgmma")],
    "quant_stream": [("gemm_packed_fused_a", "tc_stream_q")],
    "quant_wgmma": [("gemm_packed_fused_a", "wgmma_q")],
    "fused_a_mma": [("gemm_packed_fused_a", "mma_quant")],
    "fused_a_fma": [("gemm_packed_fused_a", "fma_quant")],
    "blocked_mma": [(w, "mma_general") for w in _BLOCKED],
    "fma_tiled": [(w, "fma_tiled") for w in _BLOCKED + _VSX],
    "fma_stream": [(w, "fma_stream") for w in _BLOCKED + _VSX],
    "grouped_stream": [(w, "tc_stream") for w in _GROUPED],
    "grouped_wgmma": [(w, "wgmma") for w in _GROUPED],
    "grouped_quant_stream": [(w, "tc_stream_q") for w in _GROUPED],
    "grouped_quant_wgmma": [(w, "wgmma_q") for w in _GROUPED],
    "grouped_mma": [(w, "mma_sync") for w in _GROUPED],
    "grouped_fma": [(w, "fma") for w in _GROUPED],
    "k5_tma_copy": [(w, "tma_copy") for w in _PACKS],
    "k5_tma_stage": [(w, "tma_stage") for w in _PACKS],
    "k5_general": [(w, "general") for w in _PACKS],
    "flash_f32_kernel": [("flash_attention", "f32")],
    "flash_mma_kernel": [("flash_attention", "mma_general")],
    "flash_stream_kernel": [("flash_attention", "stream")],
    "flash_wgmma_kernel": [("flash_attention", "wgmma")],
}
SECOND_KERNELS = ("splitk_reduce", "grouped_reduce")
# Every check of a replay's records (label, replays, records by class).
REPLAY_CHECKS = []


def port_kernel_names() -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    import re

    from repro_torch.kernels import build
    names = set()
    for path in build.CSRC.glob("*.cu*"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s*)?(\w+)\s*\(", path.read_text()))
    return names


def kernel_class(name, ours):
    """The class of a profile's kernel ``name`` (a key of KERNEL_CLASSES, a
    SECOND_KERNELS name, or the bare name of a port kernel neither lists),
    or None for a kernel not of the port's sources (``ours``)."""
    import re
    s = name.replace("(anonymous namespace)::", "")
    s = s[len("void "):] if s.startswith("void ") else s
    base = re.match(r"\w*", s).group(0)
    if base not in ours:
        return None
    if base in ("mma_stream", "wgmma_packed"):
        return " ".join((base, "NaturalA" if "NaturalA" in s else "PackedA",
                         "NaturalB" if "NaturalB" in s else "PackedB"))
    return base


def credit_by_class(credit) -> dict:
    """What a replay launches by KERNEL_CLASSES class, as the graph credits
    it (``graphs.LaunchCredit``)."""
    of_pair = {pair: cls for cls, pairs in KERNEL_CLASSES.items()
               for pair in pairs}
    out = {}
    for fn, (_, bodies) in credit.delta.items():
        for body, n in bodies.items():
            cls = of_pair.get((fn.__name__, body))
            if cls is None:
                raise AssertionError(f"no kernel name known for {fn.__name__}'s "
                                     f"body {body}")
            out[cls] = out.get(cls, 0) + n
    return out


def replay_records(counts) -> dict:
    """The port's kernel records of a profile ({kernel name: records}) by
    KERNEL_CLASSES class, split reductions left out; a port kernel that no
    class names counts under its own name (and fails the check)."""
    ours = port_kernel_names()
    out = {}
    for name, n in counts.items():
        cls = kernel_class(name, ours)
        if cls is not None and cls not in SECOND_KERNELS:
            out[cls] = out.get(cls, 0) + n
    return out


# Profiles of one check, at most: a short read is profiled again.
REPLAY_PROFILES = 3


def replay_launch_check(profile, credit, reps, label, counts=None) -> dict:
    """The launches a graph credits, measured: the port's kernel records
    of ``reps`` profiled replays (``profile()`` -> {kernel name: records};
    ``counts``, where given, is the first profile's), by class, must equal
    ``reps`` times what the graph credits a replay (``credit``), class by
    class, else the run fails. A kernel launched outside the capture, or a
    launch no wrapper counted, reads as unequal. torch.profiler can lose a
    kernel record (PERF.md §7) but never adds one, so a read above the
    credit in any class fails at once, and a read below it only is
    profiled again, up to REPLAY_PROFILES profiles: a launch the replays
    lack reads short in every profile. Every read is kept in
    REPLAY_CHECKS. Returns the records by class."""
    want = {cls: n * reps for cls, n in credit_by_class(credit).items()}
    reads = []
    while True:
        got = replay_records(profile() if counts is None else counts)
        counts = None
        reads.append(got)
        over = {c: n for c, n in got.items() if n > want.get(c, 0)}
        log(f"  {label}: kernel records of {reps} replays by kernel {got}; "
            f"credited {want}: equal {got == want}"
            + ("" if got == want or over else
               f" (a short read, profile {len(reads)} of {REPLAY_PROFILES})"))
        if got == want or over or len(reads) == REPLAY_PROFILES:
            break
    REPLAY_CHECKS.append(dict(label=label, replays=reps, records=got,
                              equal=got == want, short_reads=reads[:-1]))
    if got != want:
        raise AssertionError(f"{label}: the replays' kernel records {reads} "
                             f"are not the launches the graph credits ({want})")
    return got


def kernel_counts(torch, fn, reps) -> dict:
    """{kernel name: records} of ``reps`` profiled calls of ``fn(i)``
    (``profile_kernels``)."""
    counts = {}
    profile_kernels(torch, fn, reps, counts)
    return counts


def decode_graph(engine, width):
    """The engine's decode graph of ``width`` rows (phases 2-5 serve one
    batch width; a ``prefill_request`` also makes the width-1 graph whose
    static caches its prefill writes). The prefill's graphs are kept apart
    (``engine._prefill_graphs``)."""
    (step,) = [g for g in engine._graphs.values()
               if g.static["tok"].shape[0] == width]
    return step


class eager_steps:
    """Within the block the engine runs its eager prefill and decode
    (``_graphed = False``): the route a graph is compared with, and the one
    a run on swapped kernels must take, since a capture there would keep
    the swap."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self.graphed = self.engine._graphed
        self.engine._graphed = False

    def __exit__(self, *exc):
        self.engine._graphed = self.graphed


def prefill_graph_of(engine, batch):
    """The engine's prefill graph for ``batch``'s signature."""
    from repro_torch.serve import graphs
    return engine._prefill_graphs[graphs.signature(batch)]


def prefill_graph_bitwise(torch, engine, batch) -> tuple:
    """The engine's prefill graph for ``batch``, called until a call has
    replayed it, against the eager prefill: (its logits bitwise the eager
    prefill's, the caches it writes bitwise, the graph)."""
    from repro_torch.serve import graphs
    logits_e, caches_e = engine._prefill(batch)
    for _ in range(3):
        logits_g, caches_g = engine._graphed_prefill(batch)
        step = prefill_graph_of(engine, batch)
        if step.replays:
            break
    torch.cuda.synchronize()
    leaves = [list(graphs._leaves(c)) for c in (caches_g, caches_e)]
    caches_equal = len(leaves[0]) == len(leaves[1]) and all(
        torch.equal(a, b) for a, b in zip(*leaves))
    return bool(torch.equal(logits_g, logits_e)), caches_equal, step


def prefill_graph_check(torch, engine, batch, label, reps=3) -> dict:
    """The prefill's graph for ``batch`` (the model-format batch on the
    card, as ``generate`` builds it) against the eager prefill: called
    until it has captured, then once more (a replay); its logits and the
    caches it writes bitwise the eager prefill's, else the run fails. Then
    each timed in CUDA events (``reps`` calls: the eager forward, and the
    graph's call as served, its input copy and replay), the replay alone
    timed and profiled (torch.profiler): its device busy share against the
    replay alone, and its kernel records held to the graph's credit
    (``replay_launch_check``). Returns what it measured."""
    t0 = time.perf_counter()
    logits_equal, caches_equal, step = prefill_graph_bitwise(torch, engine,
                                                             batch)
    eager_ms = time_ms(lambda i: engine._prefill(batch), reps)
    graph_ms = time_ms(lambda i: engine._graphed_prefill(batch), reps)
    replay_ms = time_ms(lambda i: step.graph.replay(), reps)
    counts = {}
    dev, kept, _ = profile_kernels(torch, lambda i: step.graph.replay(), 1,
                                   counts)
    busy = sum(dev.values()) / 1e3
    out = dict(logits_bitwise_equal=logits_equal,
               caches_bitwise_equal=caches_equal, eager_ms=eager_ms,
               graph_ms=graph_ms, replay_ms=replay_ms, replay_busy_ms=busy,
               replay_busy_share=busy / replay_ms, records_kept=kept,
               warmup_ms=step.warmup_ms, capture_ms=step.capture_ms,
               capture_reserved_bytes=step.capture_reserved_bytes,
               tokens_shape=list(batch["tokens"].shape))
    log(f"  {label}, the prefill graph ({tuple(batch['tokens'].shape)}): logits "
        f"bitwise the eager prefill's {logits_equal}, caches {caches_equal}; "
        f"eager {eager_ms:.3f} ms, graph {graph_ms:.3f} ms as served, replay "
        f"alone {replay_ms:.3f} ms (CUDA events, {reps} calls), device busy "
        f"{busy:.3f} ms = {100 * busy / replay_ms:.1f}% of the replay (records "
        f"kept {kept}); warm-up {step.warmup_ms:.1f} ms, capture "
        f"{step.capture_ms:.1f} ms, reserved "
        f"{step.capture_reserved_bytes / 1e6:.1f} MB; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (logits_equal and caches_equal):
        raise AssertionError(f"{label}: the prefill graph differs from the "
                             f"eager prefill: logits {logits_equal}, caches "
                             f"{caches_equal}")
    out["replay_records"] = replay_launch_check(
        lambda: kernel_counts(torch, lambda i: step.graph.replay(), 1),
        step.credit, 1, f"{label}, the prefill graph", counts)
    return out


def graph_against_eager(torch, counters, engine, batch, steps, label) -> dict:
    """``Engine.generate`` of ``steps`` greedy steps through the engine's
    decode graph (captured by an earlier call, so every step replays it,
    else warmed up at its first step and captured at its second) and
    eagerly (``engine._graphed = False``), the counters at 0 before
    each: the greedy tokens must be bitwise equal, and the launches by body
    of the replays equal to the eager steps'. Returns what it found."""
    import numpy as np
    runs = {}
    for mode in ("graph", "eager"):
        engine._graphed = mode == "graph"
        try:
            counters.reset()
            tokens = engine.generate(batch, max_new_tokens=steps)
            torch.cuda.synchronize()
        finally:
            engine._graphed = True
        runs[mode] = (tokens, counters.read(), counters.variants())
    (tok_g, n_g, by_g), (tok_e, n_e, by_e) = runs["graph"], runs["eager"]
    step = decode_graph(engine, batch["tokens"].shape[0])
    pre = [g for g in engine._prefill_graphs.values()
           if g.static["tokens"].shape == tuple(batch["tokens"].shape)]
    out = dict(tokens_bitwise_equal=bool(np.array_equal(tok_g, tok_e)),
               launches_equal=n_g == n_e and by_g == by_e,
               launches={k: v for k, v in n_g.items() if v},
               replays=step.replays, warmup_ms=step.warmup_ms,
               capture_ms=step.capture_ms,
               prefill_replays=sum(g.replays for g in pre))
    log(f"  {label}, graph against eager ({steps} steps, each a replay; the "
        f"prefill through its graph, then eagerly): greedy tokens bitwise "
        f"equal {out['tokens_bitwise_equal']}; launches by body equal "
        f"{out['launches_equal']} ({out['launches']}); warm-up (its first "
        f"step, host ms to issue) {step.warmup_ms:.1f} ms, capture (its "
        f"second) {step.capture_ms:.1f} ms; "
        f"{step.replays} decode replays, {out['prefill_replays']} prefill "
        f"replays so far")
    if not (out["tokens_bitwise_equal"] and out["launches_equal"]):
        raise AssertionError(f"{label}: the decode graph differs from the eager "
                             f"loop: tokens {out['tokens_bitwise_equal']}, "
                             f"launches graph {by_g} eager {by_e}")
    return out


def serve_timings(torch, engine, prompt, steps, kernel_tags, counters,
                  label="decode"):
    """The decode graph against the eager loop (``graph_against_eager``),
    then each's warm Engine.generate calls, the forwards alone, and a
    profile of the decode step (eager steps, graph replays), in which the
    replays' kernel records must be the launches the graph credits
    (``replay_launch_check``). ``kernel_tags`` maps a label to a substring
    of the CUDA kernel names, for their device time per decode step. The
    top-level keys are the graph's (the served path); ``eager`` holds the
    eager loop's. A busy share is taken against the step alone (CUDA
    events) and, with its spread over the 3 calls, against the generate
    step (host clock)."""
    b = prompt.shape[0]
    check = graph_against_eager(torch, counters, engine, {"tokens": prompt},
                                steps, "decode")

    # End to end: warm Engine.generate calls on the host clock (each step
    # copies its tokens to the host; both paths are warm from the check
    # above). `steps` steps against 1 step gives the decode step; the
    # 1-step call is prefill + sample + one step.
    def gen_ms(n_new, reps=3):
        """Each call's ms (host clock, synchronised)."""
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.generate({"tokens": prompt}, max_new_tokens=n_new)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    modes = {}
    for mode in ("graph", "eager"):
        engine._graphed = mode == "graph"
        try:
            gens, gens1 = gen_ms(steps), gen_ms(1)
        finally:
            engine._graphed = True
        ms_gen, ms_gen1 = sum(gens) / len(gens), sum(gens1) / len(gens1)
        ms_step = (ms_gen - ms_gen1) / (steps - 1)
        # The step of each pair of calls: the spread of the estimate.
        pairs = [(g - g1) / (steps - 1) for g, g1 in zip(gens, gens1)]
        modes[mode] = dict(generate_ms=ms_gen, generate_1_step_ms=ms_gen1,
                           decode_ms_per_step=ms_step,
                           decode_ms_per_step_range=[min(pairs), max(pairs)],
                           tokens_per_s=b * 1e3 / ms_step)
        log(f"  Engine.generate {b}x{prompt.shape[1]}, {mode} (warm, mean of "
            f"3): {steps} steps {ms_gen:.2f} ms, 1 step {ms_gen1:.2f} ms; "
            f"decode {ms_step:.3f} ms/step (pairs {min(pairs):.3f}-"
            f"{max(pairs):.3f}) = {b * 1e3 / ms_step:.1f} tokens/s "
            f"(batch {b}); {b * 1e3 * steps / ms_gen:.1f} tokens/s over the "
            f"whole call")

    # Forwards alone (CUDA events): no sampling, no host copy; the eager
    # step, and a replay of the decode graph (its token copy, position
    # fill and replay).
    batch = {"tokens": prompt.to(DEVICE)}
    ms_prefill = time_ms(lambda i: engine._prefill(batch), 3)
    _, caches = engine._prefill(batch)
    tok = torch.zeros((b, 1), dtype=torch.long, device=DEVICE)
    pos0 = prompt.shape[1]
    graph = decode_graph(engine, b)
    graph({"caches": caches, "tok": tok, "pos": pos0})

    def step(i):
        pos = torch.full((b,), pos0 + i % 64, dtype=torch.long, device=DEVICE)
        engine._decode(caches, tok, pos)

    def replay(i):
        graph({"tok": tok, "pos": pos0 + i % 64})
    fwd_ms = dict(eager=time_ms(step, 16), graph=time_ms(replay, 16))
    log(f"  model forward alone: prefill {b}x{prompt.shape[1]} "
        f"{ms_prefill:.2f} ms; decode eager {fwd_ms['eager']:.3f} ms/step, "
        f"graph replay {fwd_ms['graph']:.3f} ms/step")

    # -- where a decode step's time goes (torch.profiler, CUPTI) ------------
    # The profiler slows the host (wall below); each busy share is taken
    # against the unprofiled times measured above.
    steps_p = 4
    for mode, fn in (("eager", step), ("graph", replay)):
        counts = {}
        dev, kept, wall_ms = profile_kernels(torch, fn, steps_p, counts)
        per_kernel = {tag_label: sum(t for name, t in dev.items() if tag in name)
                      / steps_p / 1e3 for tag_label, tag in kernel_tags.items()}
        busy_ms = sum(dev.values()) / steps_p / 1e3
        ms_step = modes[mode]["decode_ms_per_step"]
        lo, hi = modes[mode]["decode_ms_per_step_range"]
        modes[mode].update(
            model_decode_ms=fwd_ms[mode], decode_device_busy_ms=busy_ms,
            decode_device_busy_share=busy_ms / fwd_ms[mode],
            generate_device_busy_share=busy_ms / ms_step,
            generate_device_busy_share_range=[busy_ms / hi, busy_ms / lo],
            decode_device_ms=per_kernel, decode_kernel_records=kept)
        log(f"  profile {steps_p} decode steps, {mode}: wall {wall_ms:.3f} "
            f"ms/step (profiled), device busy {busy_ms:.3f} ms/step = "
            f"{100 * busy_ms / fwd_ms[mode]:.1f}% of the step alone (events, "
            f"{fwd_ms[mode]:.3f} ms; {100 * busy_ms / ms_step:.1f}% of the "
            f"generate step, {100 * busy_ms / hi:.1f}-{100 * busy_ms / lo:.1f}% "
            f"over its pairs of calls), "
            + ", ".join(f"{tag_label} {ms:.3f} ms/step"
                        for tag_label, ms in per_kernel.items())
            + f", {len(dev)} kernel names, kernel records kept {kept} launches")
        for name, t in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {t / steps_p / 1e3:8.3f} ms/step  {name[:90]}")
        if mode == "graph":
            check["replay_records"] = replay_launch_check(
                lambda: kernel_counts(torch, replay, steps_p), graph.credit,
                steps_p, f"{label}, the decode graph", counts)
    prefill = prefill_graph_check(torch, engine, batch, label)
    return dict(modes["graph"], model_prefill_ms=ms_prefill,
                eager=modes["eager"], graph_check=check,
                prefill_graph=prefill)


# The sampled decode (phases 2 and 2b): the temperature and the seed.
SAMPLE_TEMPERATURE, SAMPLE_SEED = 0.7, 11


class sampled:
    """Within the block the engine samples at SAMPLE_TEMPERATURE (its
    draws keyed by SAMPLE_SEED); its greedy config is restored after."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self.cfg = self.engine.cfg
        self.engine.cfg = dataclasses.replace(
            self.cfg, temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED)

    def __exit__(self, *exc):
        self.engine.cfg = self.cfg


def sampled_decode_check(torch, engine, prompt, steps, label) -> dict:
    """A sampled ``Engine.generate`` (SAMPLE_TEMPERATURE) through the
    graphs, the decode graph's replays feeding the sampler's graph (one for
    the batch's logits shape: its warm-up, its capture, then replays),
    against the eager loop and its eager draws: the tokens must be bitwise
    equal, and the sampler's graph must have replayed. Then warm calls on
    the graphs, greedy and sampled in turns, 3 rounds (host clock,
    synchronised): ms a decode step of each as ``serve_timings`` takes it
    ((``steps`` steps - 1 step) / (steps - 1)), and their difference."""
    import numpy as np
    batch = {"tokens": prompt}
    with sampled(engine):
        tok_g = engine.generate(batch, max_new_tokens=steps)
        with eager_steps(engine):
            tok_e = engine.generate(batch, max_new_tokens=steps)
        torch.cuda.synchronize()
        tok_g2 = engine.generate(batch, max_new_tokens=steps)
    greedy = engine.generate(batch, max_new_tokens=steps)
    (graph,) = [g for g in engine._sample_graphs.values()
                if g.static["logits"].shape[0] == prompt.shape[0]]
    bitwise = bool(np.array_equal(tok_g, tok_e)) and bool(
        np.array_equal(tok_g2, tok_g))
    times = {"greedy": ([], []), "sampled": ([], [])}
    for rnd in range(3):
        order = ("greedy", "sampled") if rnd % 2 == 0 else ("sampled", "greedy")
        for mode in order:
            for n_new, into in ((steps, times[mode][0]), (1, times[mode][1])):
                with (sampled(engine) if mode == "sampled"
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    engine.generate(batch, max_new_tokens=n_new)
                    torch.cuda.synchronize()
                    into.append((time.perf_counter() - t0) * 1e3)
    ms = {mode: (sum(a) / len(a) - sum(b) / len(b)) / (steps - 1)
          for mode, (a, b) in times.items()}
    pairs = [((s - s1) - (g - g1)) / (steps - 1) for s, s1, g, g1 in zip(
        *times["sampled"], *times["greedy"])]
    out = dict(temperature=SAMPLE_TEMPERATURE, tokens_bitwise_eager=bitwise,
               tokens_differ_from_greedy=not np.array_equal(tok_g, greedy),
               sampler_replays=graph.replays,
               sampler_capture_ms=graph.capture_ms,
               sampled_ms_per_step=ms["sampled"],
               greedy_ms_per_step=ms["greedy"],
               sampled_minus_greedy_ms=ms["sampled"] - ms["greedy"],
               sampled_minus_greedy_range=[min(pairs), max(pairs)],
               sampled_tokens_per_s=prompt.shape[0] * 1e3 / ms["sampled"])
    log(f"  {label}, sampled decode (T {SAMPLE_TEMPERATURE}), graphs against "
        f"eager: tokens bitwise {bitwise} (differ from greedy "
        f"{out['tokens_differ_from_greedy']}); the sampler's graph "
        f"{graph.replays} replays, capture {graph.capture_ms:.1f} ms; warm "
        f"generate on the graphs, 3 rounds in turns: sampled "
        f"{ms['sampled']:.3f} ms/step, greedy {ms['greedy']:.3f} ms/step, "
        f"difference {ms['sampled'] - ms['greedy']:.3f} ms (rounds "
        f"{min(pairs):.3f}-{max(pairs):.3f}); "
        f"{out['sampled_tokens_per_s']:.1f} tokens/s sampled")
    if not bitwise or not graph.replays:
        raise AssertionError(f"{label}: the sampled decode on the graphs "
                             f"differs from the eager one, or its sampler's "
                             f"graph never replayed")
    return out


# The raw prefill's kernels in a profile: K5's three bodies ("k5_"), K1's
# wgmma body (on NaturalA with packed B), the last-position LM head on K7's
# tc_stream (NaturalB).
RAW_PREFILL_TAGS = {"K5": "k5_", "K1 wgmma": "wgmma_packed", "K7": "NaturalB"}


def prefill_profile(torch, engine, prompt, prefill_ms, kernel_tags, k5_calls,
                    forwards=2) -> dict:
    """Where one warm prefill forward's device time goes (torch.profiler,
    ``forwards`` forwards): device busy ms a forward, its share of the
    unprofiled forward (``prefill_ms``, CUDA events), and each tag's
    kernel ms a forward, with the K5 launches the profile kept of
    ``k5_calls`` a forward (it can lose records in a long process). Then
    the forward in CUDA events (5 a turn) with K5 on the bodies pack_body
    routes to and with every pack forced onto ``general`` (the element
    kernel; a measurement only), in turns: general, routed, routed,
    general, general, routed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import pack as pk
    batch = {"tokens": prompt.to(DEVICE)}
    engine._prefill(batch)
    torch.cuda.synchronize()
    routed = pk.pack_body
    turns = []
    for body in ("general", "routed", "routed", "general", "general", "routed"):
        if body == "general":
            pk.pack_body = lambda *args: "general"
        try:
            turns.append((body, time_ms(lambda i: engine._prefill(batch), 5)))
        finally:
            pk.pack_body = routed
    ab = {body: [ms for b, ms in turns if b == body] for body in ("routed", "general")}
    log(f"  raw prefill forward, CUDA events (in turns): K5 routed {ab['routed']} ms, "
        f"K5 forced onto general {ab['general']} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            engine._prefill(batch)
        torch.cuda.synchronize()
    dev, counts = {}, {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev[ev.key], counts[ev.key] = t, ev.count
    busy = sum(dev.values()) / forwards / 1e3
    per_kernel = {label: sum(t for name, t in dev.items() if tag in name) / forwards / 1e3
                  for label, tag in kernel_tags.items()}
    k5_kept = sum(c for name, c in counts.items() if kernel_tags["K5"] in name)
    log(f"  profile {forwards} raw prefill forwards: device busy {busy:.3f} ms a "
        f"forward = {100 * busy / prefill_ms:.1f}% of the unprofiled forward "
        f"({prefill_ms:.2f} ms), " + ", ".join(
            f"{label} {ms:.3f} ms" for label, ms in per_kernel.items())
        + f" a forward; K5 launches recorded {k5_kept} of {k5_calls * forwards}")
    for name, t in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {t / forwards / 1e3:8.3f} ms a forward  {name[:90]}")
    return dict(prefill_ms=prefill_ms, device_busy_ms=busy,
                device_busy_share=busy / prefill_ms, device_ms=per_kernel,
                k5_records=k5_kept, k5_launches=k5_calls * forwards,
                forward_ms_k5_routed=ab["routed"], forward_ms_k5_general=ab["general"])


def bf16_tree(torch, tree):
    """Every floating leaf of a parameter tree as bf16 (the compute dtype)."""
    if isinstance(tree, dict):
        return {k: bf16_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [bf16_tree(torch, v) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(torch.bfloat16)
    return tree


def phase_serve(torch, gp, counters, cfgs, models, serve):
    """Full-width olmo-1b served through the packed path. Returns (launches
    of the counted run, timings, the bf16 weights it served, its prefill
    logits of the first prompt row, the prompt)."""
    cfg = cfgs.get_config("olmo-1b")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = models.build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    # Drawn in f32 and rounded to bf16 once: the packed engine packs these
    # values, and phase 5 serves the same values raw.
    params = bf16_tree(torch, model.init(0))
    per_forward = 7 * cfg.num_layers + 1
    # Load-time packing is on the path: every weight and the LM head
    # (table.t()) go through K5, once.
    counters.reset()
    torch.cuda.synchronize()
    t_load = time.perf_counter()
    engine = serve.Engine(model, params, serve.ServeConfig(
        max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16"),
        device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_load
    load = counters.read()
    # Every projection is a row-major bf16 matrix (tma_copy); the LM head
    # is packed from table.t(), a transpose (tma_stage).
    load_bodies = launches_by_body(counters, "pack_b")
    want_load_bodies = dict(tma_copy=per_forward - 1, tma_stage=1)
    log(f"  olmo-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; init + pack {time.perf_counter() - t0:.1f} s, of which "
        f"Engine construction (load, synchronized) {t_load * 1e3:.1f} ms; load "
        f"launches {load} (want pack_b {per_forward}, nothing else); K5 by body "
        f"{load_bodies} (want {want_load_bodies}); dispatch {engine.dispatch_report}")
    if load != counters.only(pack_b=per_forward):
        raise AssertionError(f"load-time launch counts {load}")
    if load_bodies != want_load_bodies:
        raise AssertionError(f"load-time K5 launches by body {load_bodies}")
    gen = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)

    # -- the main path, counted -------------------------------------------
    counters.reset()
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = counters.read()
    bodies = launches_by_body(counters)
    # Prefill: the 7 projections a layer at 4 x 128 rows on wgmma, the LM
    # head at the last positions (4 rows) on tc_stream; decode: tc_stream.
    want_bodies = dict(tc_stream=1 + per_forward * STEPS,
                       wgmma=7 * cfg.num_layers)
    log(f"  generate {PROMPT[0]}x{PROMPT[1]} + {STEPS} steps: {t_gen * 1e3:.1f} ms; "
        f"launches {launches} (want gemm_packed_fused_a {per_forward} x "
        f"{STEPS + 1} = {per_forward * (STEPS + 1)}, nothing else); K1 by "
        f"body {bodies} (want {want_bodies})")
    if launches != counters.only(gemm_packed_fused_a=per_forward * (STEPS + 1)):
        raise AssertionError(f"launch counts {launches}")
    if bodies != want_bodies:
        raise AssertionError(f"K1 launches by body {bodies}")
    check_tokens(tokens, cfg)

    # -- logits against the plain version on the card ----------------------
    # The reference forward swaps the kernel for its plain version where the
    # packed-weight lowering calls it, for this one prefill only.
    logits_k = engine.prefill_request(prompt[0])[0].clone()
    with plain_kernels(gp, None), eager_steps(engine):
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

    timings = serve_timings(torch, engine, prompt, STEPS, K1_KERNEL_TAGS,
                            counters, "olmo-1b packed")
    timings["sampled"] = sampled_decode_check(torch, engine, prompt, STEPS,
                                              "olmo-1b packed")
    timings.update(rel_fro=rel, first_generate_ms=t_gen * 1e3,
                   k1_launches_by_body=bodies, load_ms=t_load * 1e3,
                   k5_load_launches_by_body=load_bodies)
    del engine
    return load, launches, timings, (model, params, logits_k, prompt)


# Phase 2b: full-width olmo-1b through the continuous-batching scheduler.
CONT_REQUESTS, CONT_PROMPT, CONT_BUDGET = 24, (16, 128), (8, 48)
CONT_LIVE, CONT_BLOCK, CONT_SUBSET = 8, 16, 8


def continuous_requests(serve, vocab, n=CONT_REQUESTS, seed=7):
    """``n`` requests from ``seed``: prompts of CONT_PROMPT tokens, budgets
    of CONT_BUDGET greedy tokens, every one arriving at t = 0."""
    import numpy as np
    r = np.random.default_rng(seed)
    return [serve.Request(
        request_id=i,
        tokens=r.integers(0, vocab, int(r.integers(CONT_PROMPT[0],
                                                   CONT_PROMPT[1] + 1))),
        max_new_tokens=int(r.integers(CONT_BUDGET[0], CONT_BUDGET[1] + 1)))
        for i in range(n)]


class ForwardCount:
    """The forwards of a scheduler's run, counted: the model's prefills
    (prefills of more than 16 rows apart: their projections take K1's wgmma
    body, every other forward tc_stream) and the batched steps that ran
    (``count_steps``: each call of a scheduler's ``_step`` runs one decode
    forward, eagerly or as a graph's warm-up or replay). A prefill runs
    eagerly (an Engine built on ``model`` calls these: its eager prefill,
    or a prefill graph's warm-up; a capture pass, which runs no forward, is
    not counted) or as a replay of one of the engine's prefill graphs
    (``watch(engine)``; read from the graphs' replay counts)."""

    def __init__(self, model):
        from repro_torch.core import health
        self.eager_prefills = self.eager_long = self.decodes = 0
        self._engine = None
        self._base = (0, 0, 0)

        def prefill(params, batch, **kw):
            if not health.capturing():
                self.eager_prefills += 1
                self.eager_long += int(batch["tokens"].shape[1] > 16)
            return model.prefill(params, batch, **kw)
        self.model = dataclasses.replace(model, prefill=prefill)

    def watch(self, engine):
        """Count the replays of ``engine``'s prefill graphs too (held by a
        weak reference: the engine's model holds this counter)."""
        import weakref
        self._engine = weakref.ref(engine)
        self._base = self._graphs()

    def _graphs(self) -> tuple:
        """(replays, replays of prompts over 16 tokens, graphs captured) of
        the watched engine's prefill graphs."""
        engine = self._engine() if self._engine is not None else None
        steps = list(engine._prefill_graphs.values()) if engine else []
        return (sum(g.replays for g in steps),
                sum(g.replays for g in steps
                    if g.static["tokens"].shape[1] > 16),
                sum(g.graph is not None for g in steps))

    @property
    def prefills(self) -> int:
        return self.eager_prefills + self._graphs()[0] - self._base[0]

    @property
    def long_prefills(self) -> int:
        return self.eager_long + self._graphs()[1] - self._base[1]

    def prefill_graphs(self) -> dict:
        """The prefill graphs' captures and replays since the last reset,
        and the prefills that ran eagerly (warm-ups, or the eager route)."""
        now = self._graphs()
        return dict(captures=now[2] - self._base[2],
                    replays=now[0] - self._base[0], eager=self.eager_prefills)

    def count_steps(self, cs):
        step = cs._step

        def counted(*args):
            self.decodes += 1
            return step(*args)
        cs._step = counted

    def reset(self):
        self.eager_prefills = self.eager_long = self.decodes = 0
        self._base = self._graphs()


def prefill_replays(engine) -> dict:
    """{signature: replays so far} of the engine's prefill graphs."""
    return {k: g.replays for k, g in engine._prefill_graphs.items()}


def prefill_replay_checks(torch, engine, before, label) -> dict:
    """The prefill graphs replayed since ``before`` (``prefill_replays``)
    held to their credit (``replay_launch_check``, one profiled replay
    each): the shortest prompt and the longest, whose projections take
    K1's tc_stream body at 16 tokens and wgmma above. Returns the records
    by prompt length."""
    replayed = sorted((g for k, g in engine._prefill_graphs.items()
                       if g.replays > before.get(k, 0)),
                      key=lambda g: g.static["tokens"].shape[1])
    out = {}
    for g in replayed[:1] + replayed[1:][-1:]:
        shape = tuple(g.static["tokens"].shape)
        out[shape[1]] = replay_launch_check(
            lambda g=g: kernel_counts(torch, lambda i: g.graph.replay(), 1),
            g.credit, 1, f"{label}, the prefill graph of {shape}")
    return out


def prefill_shares(counts) -> str:
    """A run's prefills through the graphs (``ForwardCount.prefill_graphs``)
    by kind: eager warm-ups, captures (each also replays) and replays."""
    n = counts["eager"] + counts["replays"]
    if not n:
        return "none"
    return (f"{n} prefills, {counts['eager']} warm-ups "
            f"({100 * counts['eager'] / n:.1f}%), {counts['captures']} "
            f"captures ({100 * counts['captures'] / n:.1f}%), "
            f"{counts['replays']} replays ({100 * counts['replays'] / n:.1f}%, "
            f"the captures' own among them)")


def continuous_run(torch, serve, engine, counters, fwd, reqs, label, *,
                   fault=None, record=None, graphed=True, **cfg):
    """Serve ``reqs`` (all at t = 0) through a fresh ContinuousScheduler,
    its batched step and the engine's prefills through their captured
    graphs (``graphed``) or eager, counted:
    conservation and a drained pool, K1 the only kernel, every launch on
    tc_stream or wgmma (113 a forward: 112 projections and the LM head; a
    prefill's projections on wgmma). ``fault`` arms batch_step at those
    hits; ``record`` (a dict) gets each decoded token's logits row by
    (request id, step). Returns what the run measured."""
    from repro_torch.core import health
    from repro_torch.testing import faults
    health.clear_serve()
    counters.reset()
    fwd.reset()
    cs = serve.ContinuousScheduler(engine, serve.ContinuousConfig(
        queue_capacity=len(reqs), max_live=CONT_LIVE, block_size=CONT_BLOCK,
        max_retries=1, **cfg))
    cs._graphed = graphed
    engine._graphed = graphed
    fwd.count_steps(cs)
    replays_before = prefill_replays(engine)
    if record is not None:
        commit = cs._commit_rows

        def commit_rows(done, rows, logits_b):
            for row in rows:
                slot = cs._live[row]
                record[slot.req.request_id, len(slot.emitted)] = logits_b[row].clone()
            commit(done, rows, logits_b)
        cs._commit_rows = commit_rows
    peak = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (faults.inject("batch_step", nth=fault) if fault
          else contextlib.nullcontext()):
        for r in reqs:
            if cs.submit(r) is not None:
                raise AssertionError(f"{label}: request {r.request_id} shed")
        while cs._queue or cs._live:
            cs.step()
            peak = max(peak, cs.kv.alloc.used_count)
        cs.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine._graphed = True
    launches, bodies = counters.read(), launches_by_body(counters)
    prefill_graphs = fwd.prefill_graphs()
    s = cs.stats()
    events = {}
    for rec in engine.serve_report()["requests"].values():
        for e in rec["events"]:
            name = e["event"] + (":" + e["detail"].split(":")[0]
                                 if e["event"] == "bisect" else "")
            events[name] = events.get(name, 0) + 1
    health.clear_serve()
    per_forward = 7 * engine.model.cfg.num_layers + 1
    want = per_forward * (fwd.prefills + fwd.decodes)
    want_bodies = {"wgmma": (per_forward - 1) * fwd.long_prefills,
                   "tc_stream": want - (per_forward - 1) * fwd.long_prefills}
    want_bodies = {k: v for k, v in want_bodies.items() if v}
    # The counting wrapper and the recording one close over the scheduler:
    # take them off, so that the scheduler, its pool, its graph and the
    # engine it holds go when the run returns.
    del cs._step
    if record is not None:
        del cs._commit_rows
    tokens = {rid: res.tokens.tolist() for rid, res in cs.results.items()}
    n_tok = sum(len(t) for t in tokens.values())
    out = dict(label=label, graphed=graphed, wall_s=wall, tokens=n_tok,
               tokens_per_s=n_tok / wall, ms_per_step=wall * 1e3 / fwd.decodes,
               prefills=fwd.prefills, decode_steps=fwd.decodes, peak_blocks=peak,
               kv_blocks=cs.kv.alloc.capacity, pool_bytes=cs.kv.pool_bytes(),
               stats=s, events=events, k1_launches=launches["gemm_packed_fused_a"],
               k1_launches_by_body=bodies, prefill_graphs=prefill_graphs)
    if graphed:
        # What a replay of the scheduler's step launches, measured: one
        # replay profiled (the graph alone: its credit is not applied, and
        # the pool, scattered outside the graph, is not touched).
        sg = cs._step_graph
        out.update(replays=sg.replays, capture_ms=sg.capture_ms,
                   warmup_ms=sg.warmup_ms,
                   replay_records=replay_launch_check(
                       lambda: kernel_counts(torch, lambda i: sg.graph.replay(), 1),
                       sg.credit, 1, f"{label}, the scheduler's step"),
                   prefill_replay_records=prefill_replay_checks(
                       torch, engine, replays_before, label))
    log(f"  {label}, {'graph' if graphed else 'eager'}: {n_tok} tokens in "
        f"{wall:.2f} s = {n_tok / wall:.1f} tokens/s, "
        f"{out['ms_per_step']:.2f} ms a batched step (host clock, the run's "
        f"prefills included); {fwd.prefills} prefills, {fwd.decodes} batched "
        f"steps"
        + (f" ({out['replays']} replays, capture {out['capture_ms']:.1f} ms; "
           f"prefills through their graphs: {prefill_shares(prefill_graphs)})"
           if graphed else "") + ", peak "
        f"{peak}/{cs.kv.alloc.capacity} KV blocks, pool {cs.kv.pool_bytes()} "
        f"bytes; completed {s['completed']} evicted {s['evicted']} preempted "
        f"{s['preempted']} resumed {s['resumed']} retries {s['retries']}; "
        f"events {events}; K1 {launches['gemm_packed_fused_a']} by body {bodies} "
        f"(want {want}, {want_bodies})")
    closed = (s["offered"] == s["admitted"] == len(reqs)
              and s["admitted"] == s["completed"] + s["evicted"] + s["deadline_miss"]
              and s["queued"] == s["live"] == s["preempted_open"] == 0
              and len(tokens) == len(reqs))
    if not closed:
        raise AssertionError(f"{label}: conservation does not close: {s}")
    if cs.kv.alloc.free_count != cs.kv.alloc.capacity \
            or not cs.kv.accounting_consistent():
        raise AssertionError(f"{label}: KV pool not drained")
    if launches != counters.only(gemm_packed_fused_a=want):
        raise AssertionError(f"{label}: launch counts {launches}")
    if bodies != want_bodies:
        raise AssertionError(f"{label}: K1 launches by body {bodies}")
    return out, tokens, launches


def phase_serve_continuous(torch, counters, serve, packed_run):
    """Full-width olmo-1b (phase 2's bf16 weights, packed) served through
    ContinuousScheduler(max_live 8, block_size 16) on max_len 256, bf16
    cache: runs (i) unpressured, (ii) a pool of three quarters of (i)'s peak
    blocks (preemption), (iii) (i) with batch_step armed so that bisection
    evicts one row, (iv) (i) on the int8 pool. Returns (load launches, the
    runs' launches summed, the phase's measurements)."""
    from repro_torch.core import health
    from repro_torch.testing import faults
    model, params = packed_run[:2]
    cfg = model.cfg
    fwd = ForwardCount(model)
    counters.reset()
    t0 = time.perf_counter()
    engine = serve.Engine(fwd.model, params, serve.ServeConfig(
        max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16"),
        device=DEVICE)
    torch.cuda.synchronize()
    fwd.watch(engine)
    load, load_bodies = counters.read(), launches_by_body(counters, "pack_b")
    log(f"  Engine (packed, max_len {MAX_LEN}, bf16 cache) in "
        f"{time.perf_counter() - t0:.2f} s; load launches {load}, K5 by body "
        f"{load_bodies}")
    if load != counters.only(pack_b=7 * cfg.num_layers + 1) or load_bodies != \
            dict(tma_copy=7 * cfg.num_layers, tma_stage=1):
        raise AssertionError(f"load-time launch counts {load} {load_bodies}")
    reqs = continuous_requests(serve, cfg.vocab_size)
    faults.reset()
    health.clear_serve()

    total = {}

    def both(label, **kw):
        """The run through the scheduler's graph and eagerly: the same
        tokens, statistics, lifecycle events and launches by body, else the
        phase fails. Returns the graph run's results, with the eager run's
        times beside them."""
        run_g, tok_g, launched_g = continuous_run(
            torch, serve, engine, counters, fwd, reqs, label, **kw)
        run_e, tok_e, launched_e = continuous_run(
            torch, serve, engine, counters, fwd, reqs, label, graphed=False,
            **kw)
        for launched in (launched_g, launched_e):
            for k, v in launched.items():
                total[k] = total.get(k, 0) + v
        same = dict(tokens=tok_g == tok_e, stats=run_g["stats"] == run_e["stats"],
                    events=run_g["events"] == run_e["events"],
                    launches_by_body=run_g["k1_launches_by_body"]
                    == run_e["k1_launches_by_body"])
        run_g["eager"] = {k: run_e[k] for k in ("wall_s", "tokens_per_s",
                                                 "ms_per_step", "decode_steps",
                                                 "prefills")}
        run_g["equal_to_eager"] = same
        log(f"  {label}: graph against eager: {same}; "
            f"{run_g['tokens_per_s']:.1f} against {run_e['tokens_per_s']:.1f} "
            f"tokens/s; host ms per batched step, the run's prefills included, "
            f"{run_g['ms_per_step']:.2f} against {run_e['ms_per_step']:.2f}; "
            f"prefill graphs {run_g['prefill_graphs']}")
        if not all(same.values()):
            raise AssertionError(f"{label}: the graph's run differs from the "
                                 f"eager run: {same}")
        return run_g, tok_g

    run_i, tok_i = both("(i) unpressured")
    if run_i["stats"]["completed"] != len(reqs):
        raise AssertionError("(i): not every request completed")
    tight = (3 * run_i["peak_blocks"]) // 4
    run_ii, tok_ii = both(f"(ii) {tight} KV blocks", num_kv_blocks=tight)
    if run_ii["stats"]["preempted"] < 1 \
            or run_ii["stats"]["resumed"] != run_ii["stats"]["preempted"]:
        raise AssertionError("(ii): no preempt / resume under the tight pool")
    if tok_ii != tok_i:
        raise AssertionError("(ii): preempted streams differ from (i)'s")
    run_iii, tok_iii = both("(iii) batch_step at hits 1, 2, 3", fault=(1, 2, 3))
    evicted = [rid for rid, t in tok_iii.items() if len(t) != len(tok_i[rid])]
    if run_iii["events"].get("bisect:guilty") != 1 or len(evicted) != 1 \
            or run_iii["stats"]["evicted"] != 1:
        raise AssertionError(f"(iii): bisection did not evict exactly one row: "
                             f"{run_iii['events']}")
    for rid, toks in tok_iii.items():
        if toks != tok_i[rid][:len(toks)] or (rid not in evicted
                                             and toks != tok_i[rid]):
            raise AssertionError(f"(iii): request {rid} differs from (i)")
    run_iv, tok_iv = both("(iv) int8 pool", kv_quantize="int8")
    # (i) greedy once more on the graphs, every prefill now a replay (the
    # run sampling is compared with), then (i) sampled.
    run_ig, tok_ig, launched = continuous_run(torch, serve, engine, counters,
                                              fwd, reqs, "(i) greedy again")
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v
    if tok_ig != tok_i:
        raise AssertionError("(i) greedy again: streams differ from (i)'s")
    with sampled(engine):
        run_s, tok_s = both(f"(i) sampled, T {SAMPLE_TEMPERATURE}")
    # The scheduler samples at its full width; a row's first token, at its
    # admission, at width 1.
    sample_widths = sorted(g.static["logits"].shape[0]
                           for g in engine._sample_graphs.values())
    run_s["sampler_graphs"] = {"widths": sample_widths, "replays": sum(
        g.replays for g in engine._sample_graphs.values())}
    run_s["tokens_differ_from_i"] = sum(
        a != b for rid in tok_i for a, b in zip(tok_i[rid], tok_s[rid]))
    run_s["greedy_again_tokens_per_s"] = run_ig["tokens_per_s"]
    run_s["greedy_again_ms_per_step"] = run_ig["ms_per_step"]
    log(f"  (i) sampled: {run_s['tokens_per_s']:.1f} tokens/s on the graphs, "
        f"{run_s['ms_per_step']:.2f} ms a batched step, against (i) greedy "
        f"again {run_ig['tokens_per_s']:.1f}, {run_ig['ms_per_step']:.2f} ms "
        f"(every prefill of both a replay); sampler graphs "
        f"{run_s['sampler_graphs']}; {run_s['tokens_differ_from_i']} of "
        f"{run_i['tokens']} tokens differ from (i)'s")
    if not run_s["sampler_graphs"]["replays"]:
        raise AssertionError("(i) sampled: the sampler's graphs never replayed")
    same = sum(a == b for rid in tok_i for a, b in zip(tok_i[rid], tok_iv[rid]))
    run_iv["share_equal_to_i"] = same / run_i["tokens"]
    log(f"  (iv) int8 pool: {same}/{run_i['tokens']} tokens equal to (i)'s "
        f"({100 * same / run_i['tokens']:.1f}%); pool bytes bf16 "
        f"{run_i['pool_bytes']}, int8 {run_iv['pool_bytes']} "
        f"({run_iv['pool_bytes'] / run_i['pool_bytes']:.3f}x)")

    # -- one batched step at 8 live rows: rows alone, batch-1, timings ------
    cs = serve.ContinuousScheduler(engine, serve.ContinuousConfig(
        queue_capacity=CONT_SUBSET, max_live=CONT_LIVE, block_size=CONT_BLOCK))
    for r in reqs[:CONT_SUBSET]:
        cs.submit(r)
    for _ in range(3):
        cs.step()
    if len(cs._live) != CONT_LIVE:
        raise AssertionError(f"{len(cs._live)} live rows, want {CONT_LIVE}")
    import numpy as np
    tokens = np.zeros((CONT_LIVE, 1), np.int64)
    pos = np.zeros((CONT_LIVE,), np.int64)
    for row, slot in cs._live.items():
        tokens[row, 0] = slot.emitted[-1]
        pos[row] = slot.req.tokens.shape[0] + len(slot.emitted) - 1
    tables = cs.kv.device_tables()
    # The graph's logits are its static output: kept before the row steps
    # replay the same graph.
    logits, written = cs._step(tables, tokens, pos)
    logits = logits.clone()
    alone_equal, b1_equal, b1_max = 0, 0, 0.0
    for row in range(CONT_LIVE):
        alone, _ = cs._row_step(row, int(tokens[row, 0]), int(pos[row]))
        alone_equal += bool(torch.equal(alone[row], logits[row]))
        raw, _ = engine.decode_request(cs.kv.gather_slot(row),
                                       torch.tensor([[int(tokens[row, 0])]]),
                                       int(pos[row]))
        b1_equal += bool(torch.equal(raw[0, 0], logits[row]))
        b1_max = max(b1_max, float((raw[0, 0].float() - logits[row].float())
                                   .abs().max()))
    cs._graphed = False
    eager_equal = bool(torch.equal(cs._step(tables, tokens, pos)[0], logits))
    cs._graphed = True
    log(f"  one batched step, {CONT_LIVE} live rows at positions "
        f"{pos.tolist()}, through the graph: {alone_equal}/{CONT_LIVE} rows "
        f"bitwise equal to the row alone (the others dead); bitwise the eager "
        f"step {eager_equal}; against the batch-1 decode (decode_request on "
        f"gather_slot, reported only): {b1_equal}/{CONT_LIVE} bitwise, largest "
        f"|difference| {b1_max:.3e} (|logits| max {float(logits.abs().max()):.3f})")
    if alone_equal != CONT_LIVE or not eager_equal:
        raise AssertionError("a batched row differs from the same row alone, "
                             "or the graph's step from the eager step")

    step_t = {}
    for mode in ("graph", "eager"):
        cs._graphed = mode == "graph"

        def step(i):
            return cs._step(tables, tokens, pos)
        try:
            step_ms = time_ms(step, 8)
            step_busy = device_ms(step, 4, f"phase 2b batched step, {mode}")
            t_host = time.perf_counter()
            for i in range(8):
                step(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_host) * 1e3 / 8
        finally:
            cs._graphed = True
        step_t[mode] = dict(batched_step_ms=step_ms, batched_step_host_ms=wall_ms,
                            batched_step_device_busy_ms=step_busy,
                            device_busy_share=step_busy / wall_ms)
        log(f"  batched step at {CONT_LIVE} rows, {mode}: {step_ms:.3f} ms "
            f"(events), {wall_ms:.3f} ms (host clock), device busy "
            f"{step_busy:.3f} ms = {100 * step_busy / wall_ms:.1f}% of the "
            f"host-clock step")
    gather_ms = time_ms(lambda i: cs.kv.gather(tables), 8)
    scatter_ms = time_ms(lambda i: cs._commit_pool(written), 8)
    step_ms = step_t["graph"]["batched_step_ms"]
    log(f"  gather {gather_ms:.3f} ms + scatter {scatter_ms:.3f} ms = "
        f"{100 * (gather_ms + scatter_ms) / step_ms:.1f}% of the graph's step "
        f"(the gather is inside the graph, the scatter outside)")
    cs.drain()

    # -- batched against batch-1 on the same subset ------------------------
    # Each decoded token's logits are kept on both sides (a device copy a
    # token) to find where the two greedy streams part.
    subset, rec_b, rec_1 = reqs[:CONT_SUBSET], {}, {}
    sub_b, tok_b, _ = continuous_run(torch, serve, engine, counters, fwd,
                                     subset, f"scheduler, first {CONT_SUBSET}",
                                     record=rec_b)
    health.clear_serve()
    fe = serve.StreamFrontend(engine, serve.StreamConfig(
        queue_capacity=CONT_SUBSET, max_live=CONT_LIVE))
    sample = engine.sample_tokens

    def sample_1(logits, rids, step):
        if step:
            rec_1[int(rids[0]), int(step)] = logits[0].clone()
        return sample(logits, rids, step)
    engine.sample_tokens = sample_1
    fwd.reset()
    fe_before = prefill_replays(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in subset:
        fe.submit(r)
    fe.drain()
    torch.cuda.synchronize()
    fe_wall = time.perf_counter() - t0
    fe_prefills = fwd.prefill_graphs()
    fe_decode = decode_graph(engine, 1)
    # What the front end's replays launched, measured: the width-1 decode
    # graph and its prefill graphs, each held to its credit.
    fe_records = dict(
        decode=replay_launch_check(
            lambda: kernel_counts(torch, lambda i: fe_decode.graph.replay(), 1),
            fe_decode.credit, 1, "batch-1 front end, the width-1 decode graph"),
        prefill=prefill_replay_checks(torch, engine, fe_before,
                                      "batch-1 front end"))
    # What the batch-1 graph route adds to a step: one slot's caches copied
    # into the graph's static caches and, at the commit, back.
    from repro_torch.serve import graphs
    slot_caches = graphs.clone(fe_decode.static["caches"])
    fe_copy_ms = time_ms(lambda i: (
        graphs.copy_in(fe_decode.static["caches"], slot_caches),
        graphs.copy_back(slot_caches, fe_decode.static["caches"])), 8)
    del slot_caches
    # Back to the class's method: an instance attribute holding the bound
    # method would be a cycle that keeps the engine, its weights and its
    # graphs alive past the phase, until a garbage collection.
    del engine.sample_tokens, sample
    health.clear_serve()
    fe_tok = {rid: res.tokens.tolist() for rid, res in fe.results.items()}
    fe_n = sum(len(t) for t in fe_tok.values())
    # The same requests through the eager front end (the engine's eager
    # prefill and decode): the streams must be bitwise the graphs'.
    fe_e = serve.StreamFrontend(engine, serve.StreamConfig(
        queue_capacity=CONT_SUBSET, max_live=CONT_LIVE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with eager_steps(engine):
        for r in subset:
            fe_e.submit(r)
        fe_e.drain()
        torch.cuda.synchronize()
    fe_e_wall = time.perf_counter() - t0
    health.clear_serve()
    fe_e_status = {rid: (res.status, res.tokens.tolist())
                   for rid, res in fe_e.results.items()}
    fe_status = {rid: (res.status, res.tokens.tolist())
                 for rid, res in fe.results.items()}
    fe_bitwise = fe_status == fe_e_status
    log(f"  batch-1 StreamFrontend on the graphs (the prefill's, one per prompt "
        f"length: {prefill_shares(fe_prefills)}; the width-1 decode graph: "
        f"{fe_decode.replays} replays so far, capture "
        f"{fe_decode.capture_ms:.1f} ms; a slot's caches copied in and back "
        f"{fe_copy_ms:.3f} ms a step, CUDA events): {fe_n} tokens in "
        f"{fe_wall:.2f} s = "
        f"{fe_n / fe_wall:.1f} tokens/s; eager {fe_n} tokens in "
        f"{fe_e_wall:.2f} s = {fe_n / fe_e_wall:.1f} tokens/s "
        f"({fe_e_wall / fe_wall:.2f}x); streams bitwise the eager front "
        f"end's {fe_bitwise}")
    if not fe_bitwise:
        raise AssertionError("the batch-1 front end's streams on the graphs "
                             "differ from its eager streams")
    fe_same = sum(a == b for rid in fe_tok for a, b in zip(fe_tok[rid], tok_b[rid]))
    if fe_n != sub_b["tokens"]:
        raise AssertionError("the batch-1 front end emitted another count")
    # Steps whose histories agree: are the two logits rows bitwise equal?
    pairs = bitwise = ties = 0
    parted = []
    for rid, toks in fe_tok.items():
        for step in range(1, len(toks)):
            if toks[:step] != tok_b[rid][:step]:
                break
            a, b = rec_1[rid, step], rec_b[rid, step]
            pairs += 1
            if torch.equal(a, b):
                bitwise += 1
                ties += toks[step] != tok_b[rid][step]
            else:
                parted.append(dict(request=rid, step=step, max_abs_diff=float(
                    (a.float() - b.float()).abs().max()),
                    same_argmax=toks[step] == tok_b[rid][step]))
    del rec_b, rec_1
    log(f"  batch-1 against batched, steps with equal histories: {bitwise}/"
        f"{pairs} logits rows bitwise equal ({ties} of them gave other "
        f"tokens); first differing rows {parted[:4]}")
    log(f"  batch-1 StreamFrontend, first {CONT_SUBSET} requests: {fe_n} tokens "
        f"in {fe_wall:.2f} s = {fe_n / fe_wall:.1f} tokens/s; the scheduler "
        f"{sub_b['tokens_per_s']:.1f} tokens/s = "
        f"{sub_b['tokens_per_s'] * fe_wall / fe_n:.2f}x; greedy tokens equal "
        f"{fe_same}/{fe_n} (reported only)")
    fe_replays = fe_decode.replays
    del cs, fe, fe_e, fe_decode, engine
    out = dict(runs=[run_i, run_ii, run_iii, run_iv, run_s],
               **step_t["graph"], eager_step=step_t["eager"],
               graph_step_equal_to_eager=eager_equal,
               gather_ms=gather_ms, scatter_ms=scatter_ms,
               gather_scatter_share=(gather_ms + scatter_ms) / step_ms,
               rows_alone_equal=alone_equal, batch1_rows_equal=b1_equal,
               batch1_max_abs_diff=b1_max, subset_scheduler=sub_b,
               subset_frontend_tokens_per_s=fe_n / fe_wall,
               subset_frontend_eager_tokens_per_s=fe_n / fe_e_wall,
               frontend_graph_bitwise_eager=fe_bitwise,
               frontend_prefill_graphs=fe_prefills,
               frontend_replay_records=fe_records,
               frontend_decode_replays=fe_replays,
               frontend_copy_ms=fe_copy_ms,
               batched_over_batch1=sub_b["tokens_per_s"] * fe_wall / fe_n,
               frontend_equal_tokens=fe_same / fe_n,
               frontend_rows_compared=pairs, frontend_rows_bitwise=bitwise,
               frontend_rows_parted=parted[:8],
               pool_bytes_bf16=run_i["pool_bytes"], k5_load_launches_by_body=load_bodies,
               pool_bytes_int8=run_iv["pool_bytes"],
               k1_launches_by_body={r["label"]: r["k1_launches_by_body"]
                                    for r in (run_i, run_ii, run_iii, run_iv)})
    return load, total, out


def phase_serve_raw(torch, counters, ctr, serve, packed_run):
    """Full-width olmo-1b served with RAW bf16 weights through the default
    ``Engine(model, params)`` (``ServeConfig()``: no packing, f32 KV cache):
    every contraction lowers to the planner's pick on the card, gemm_tiled
    (K7) at decode, pack_b (K5) + gemm_packed_fused_a (K1) at prefill (the
    last-position LM head, 4 rows, to K7). The weights are phase 2's, drawn
    in bf16, so the per-call cast to the compute dtype is a no-op."""
    model, params, logits_packed, prompt = packed_run
    cfg = model.cfg
    engine = serve.Engine(model, params)
    log(f"  dispatch {engine.dispatch_report}")
    layers = cfg.num_layers
    want = counters.only(
        gemm_tiled=(7 * layers + 1) * STEPS + 1,
        pack_b=7 * layers, gemm_packed_fused_a=7 * layers)

    # Which lowering each dense contraction dispatches to, counted on the
    # registry's records (torch_matmul must take none).
    real = dict(ctr.LOWERINGS)
    picks = {}

    def counting(low):
        def run(*args, **kw):
            picks[low.name] = picks.get(low.name, 0) + 1
            return low.run(*args, **kw)
        return dataclasses.replace(low, run=run)

    try:
        for name, low in real.items():
            ctr.LOWERINGS[name] = counting(low)
        counters.reset()
        t0 = time.perf_counter()
        tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = counters.read()
        bodies = launches_by_body(counters)
        k7_bodies = launches_by_body(counters, "gemm_tiled")
        k5_bodies = launches_by_body(counters, "pack_b")
    finally:
        ctr.LOWERINGS.update(real)
    want_bodies = dict(wgmma=7 * layers)   # the prefill's 4 x 128 rows
    # Every K7 launch (decode, and the prefill's last-position LM head) has
    # 4 rows of aligned bf16 operands: tc_stream. The prefill packs each
    # row-major bf16 projection per call: tma_copy.
    want_k7 = dict(tc_stream=want["gemm_tiled"])
    want_k5 = dict(tma_copy=want["pack_b"])
    log(f"  generate {PROMPT[0]}x{PROMPT[1]} + {STEPS} steps: {t_gen * 1e3:.1f} "
        f"ms; launches {launches} (want {want}); lowerings {picks}; K1 by "
        f"body {bodies} (want {want_bodies}); K7 by body {k7_bodies} (want "
        f"{want_k7}); K5 by body {k5_bodies} (want {want_k5})")
    if launches != want or picks.get("torch_matmul", 0) != 0:
        raise AssertionError(f"raw-weight launch counts {launches}, "
                             f"lowerings {picks}")
    if bodies != want_bodies or k7_bodies != want_k7 or k5_bodies != want_k5:
        raise AssertionError(f"K1 launches by body {bodies}, K7 {k7_bodies}, "
                             f"K5 {k5_bodies}")
    check_tokens(tokens, cfg)

    logits_raw = engine.prefill_request(prompt[0])[0].clone()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_raw).all()):
        raise AssertionError("non-finite logits")
    rel, max_err, same_tok = compare_logits(torch, logits_raw, logits_packed)
    # The same bf16 weights through other kernels (K7 and K5 + K1 against
    # K1 on load-time-packed tiles): the activations round to bf16 after
    # each projection in other summation orders, as between phase 2's
    # kernel and plain runs: limit 5e-2 relative (Frobenius), same argmax.
    log(f"  prefill logits raw vs packed (phase 2): rel_fro={rel:.3e} (limit "
        f"5e-2), max_abs_err={max_err:.3e}, same argmax {same_tok}/1")
    if rel > 5e-2 or same_tok != 1:
        raise AssertionError("raw-weight logits disagree with the packed run")
    timings = serve_timings(torch, engine, prompt, STEPS, K7_KERNEL_TAGS,
                            counters, "olmo-1b raw")
    timings.update(rel_fro_vs_packed=rel, first_generate_ms=t_gen * 1e3,
                   lowerings=picks, k1_launches_by_body=bodies,
                   k7_launches_by_body=k7_bodies, k5_launches_by_body=k5_bodies,
                   prefill_profile=prefill_profile(
                       torch, engine, prompt, timings["model_prefill_ms"],
                       RAW_PREFILL_TAGS, want["pack_b"]))
    del engine
    return launches, timings


def check_tokens(tokens, cfg):
    if tokens.shape != (PROMPT[0], STEPS) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    log(f"  tokens[0][:8] = {tokens[0][:8].tolist()}")


def launches_by_body(counters, name="gemm_packed_fused_a") -> dict:
    """A wrapper's launches by body (K1's by default) since the counters
    were set to 0 (bodies with at least one)."""
    return {v: c for v, c in counters.variants()[name].items() if c}


# K1's CUDA kernels in a profile, by a piece of their names: tc_stream and
# wgmma are K6's templates instantiated on natural A (NaturalA), the
# quantized bodies fused_a_*, and the split reduction after tc_stream.
K1_KERNEL_TAGS = {"K1 tc_stream": "mma_stream", "K1 wgmma": "wgmma_packed",
                  "K1 quantized": "fused_a", "splitk_reduce": "splitk_reduce"}
# K7's at raw decode, where no K1 runs: its TMA bodies are the only ones
# instantiated on natural B ("NaturalB"), all on tc_stream there
# ("mma_stream", K1's too where K1 runs), with their split reduction
# ("splitk_reduce"); blocked_mma is mma_general; K5's bodies are k5_*.
K7_KERNEL_TAGS = {"K7": "NaturalB", "mma_stream": "mma_stream",
                  "splitk_reduce": "splitk_reduce", "K7 mma_general": "blocked_mma",
                  "K5": "k5_"}
# K2's: all of them ("grouped_"), then by body (the split reduction after
# tc_stream apart).
K2_KERNEL_TAGS = {"K2": "grouped_", "K2 tc_stream": "grouped_stream",
                  "K2 reduce": "grouped_reduce", "K2 wgmma": "grouped_wgmma"}


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


def mixtral_prefill_check(torch, gp, gg, engine, prompt, cfg) -> dict:
    """mixtral-8x22b's prefill logits on the kernels against the plain
    versions on the card (the gate of phases 3 and 3b). Returns the kernel
    run's logits, the errors, the expert-choice flips and the routing."""
    from repro_torch.models import moe
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

    batch = {"tokens": prompt.to(DEVICE)}
    try:
        moe.route = recording("kernel")
        logits_k, _ = engine._prefill(batch)
        with plain_kernels(gp, gg):
            moe.route = recording("free")
            logits_f, _ = engine._prefill(batch)
            moe.route = recording("pinned", replay=runs["kernel"])
            logits_p, _ = engine._prefill(batch)
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
        f"(limit 5e-2), max_abs_err={err_p:.3e}, same argmax {same_p}/"
        f"{prompt.shape[0]}; "
        f"routing free: rel_fro={rel_f:.3e} (limit 0.5), max_abs_err="
        f"{err_f:.3e}, same argmax {same_f}/{prompt.shape[0]}; |logits|max="
        f"{float(logits_k.abs().max()):.3f}")
    if rel_p > 5e-2 or rel_f > 0.5:
        raise AssertionError("served logits disagree with the plain versions")
    counts = [r[3]["counts"].tolist() for r in runs["kernel"]]
    dropped = [int(r[3]["dropped"]) for r in runs["kernel"]]
    log(f"  prefill routing per layer: counts {counts}, dropped {dropped}")
    del runs
    return dict(logits=logits_k, rel_p=rel_p, rel_f=rel_f, flips_free=flips_free,
                n_choices=n_choices, counts=counts, dropped=dropped)


def phase_mixtral(torch, gp, gg, counters, cfgs, models, serve):
    """mixtral-8x22b at its published widths, 4 of 56 layers, served through
    the packed path: K1 for attention and the LM head, K2 for the experts.
    Returns (load launches, launches of the counted run, timings, the
    kernel run's prefill logits)."""
    cfg = dataclasses.replace(cfgs.get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS,
                              compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    # What the earlier phases still hold (olmo-1b's weights, kept for
    # phase 5): part of every peak below.
    held_gb = torch.cuda.memory_allocated() / 1e9
    model = models.build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(0)
    raw_gb = torch.cuda.memory_allocated() / 1e9
    # Load-time packing through K5: attention projections and the LM head
    # by pack_b, the three expert stacks of each layer by pack_b_grouped.
    want_load = counters.only(pack_b=4 * cfg.num_layers + 1,
                              pack_b_grouped=3 * cfg.num_layers)
    counters.reset()
    torch.cuda.synchronize()
    t_load = time.perf_counter()
    engine = serve.Engine(model, params, serve.ServeConfig(
        max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16"),
        device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_load
    del params
    load = counters.read()
    # Attention projections and expert stacks are row-major bf16
    # (tma_copy); the LM head is packed from table.t() (tma_stage).
    load_bodies = {name: launches_by_body(counters, name)
                   for name in ("pack_b", "pack_b_grouped")}
    want_load_bodies = dict(
        pack_b=dict(tma_copy=4 * cfg.num_layers, tma_stage=1),
        pack_b_grouped=dict(tma_copy=3 * cfg.num_layers))
    torch.cuda.empty_cache()
    log(f"  mixtral-8x22b: {cfg.num_layers} of 56 layers (depth is the only "
        f"cut, forced by memory), d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads / {cfg.num_kv_heads} KV x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok}, vocab "
        f"{cfg.vocab_size}, window {cfg.sliding_window}; init + pack "
        f"{time.perf_counter() - t0:.1f} s; after init {raw_gb:.1f} GB "
        f"allocated (raw f32 weights, and olmo-1b's kept for phase 5), "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, packed "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB; Engine construction (load, "
        f"synchronized) {t_load * 1e3:.1f} ms; load launches {load} (want "
        f"{want_load}); K5 by body {load_bodies} (want {want_load_bodies}); "
        f"dispatch {engine.dispatch_report}")
    if load != want_load:
        raise AssertionError(f"load-time launch counts {load}")
    if load_bodies != want_load_bodies:
        raise AssertionError(f"load-time K5 launches by body {load_bodies}")
    load_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cpu").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)
    want_k1 = (4 * cfg.num_layers + 1) * (STEPS + 1)
    want_k2 = 2 * cfg.num_layers * (STEPS + 1)

    # -- the main path, counted -------------------------------------------
    counters.reset()
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = counters.read()
    bodies = launches_by_body(counters)
    want_bodies = dict(tc_stream=1 + (4 * cfg.num_layers + 1) * STEPS,
                       wgmma=4 * cfg.num_layers)
    # K2: the prefill's segments (C = 160) on wgmma, every decode step's
    # (C = 8) on tc_stream; nothing on PR 12's bodies.
    bodies_k2 = launches_by_body(counters, "gemm_grouped_packed_ragged")
    want_bodies_k2 = dict(tc_stream=2 * cfg.num_layers * STEPS,
                          wgmma=2 * cfg.num_layers)
    log(f"  generate 4x128 + {STEPS} steps: {t_gen * 1e3:.1f} ms; launches "
        f"{launches} (want K1 {want_k1}, K2 {want_k2}, K3 0: the model always "
        f"passes counts); K1 by body {bodies} (want {want_bodies}); K2 by "
        f"body {bodies_k2} (want {want_bodies_k2})")
    if launches != counters.only(gemm_packed_fused_a=want_k1,
                                 gemm_grouped_packed_ragged=want_k2):
        raise AssertionError(f"launch counts {launches}")
    if bodies != want_bodies:
        raise AssertionError(f"K1 launches by body {bodies}")
    if bodies_k2 != want_bodies_k2:
        raise AssertionError(f"K2 launches by body {bodies_k2}")
    check_tokens(tokens, cfg)

    # -- logits against the plain versions on the card ---------------------
    check = mixtral_prefill_check(torch, gp, gg, engine, prompt, cfg)
    rel_p, rel_f, flips_free = check["rel_p"], check["rel_f"], check["flips_free"]
    n_choices, counts, dropped = (check["n_choices"], check["counts"],
                                  check["dropped"])

    timings = serve_timings(torch, engine, prompt, STEPS,
                            {**K1_KERNEL_TAGS, **K2_KERNEL_TAGS}, counters,
                            "mixtral-8x22b packed")
    # The decode graph's static caches and pool sit beside the packed
    # weights. The peaks: to the end of the load (init, packing), and over
    # the served runs after it.
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_gb = max(load_peak_gb, serve_peak_gb)
    graph_gb = torch.cuda.memory_allocated() / 1e9
    graph = decode_graph(engine, PROMPT[0])
    static_gb = graph.static_bytes / 1e9
    pool_gb = graph.capture_reserved_bytes / 1e9
    # The prefill's graph writes the decode graph's static caches and
    # shares its pool: its capture reserves the pool's new segments only.
    prefill_pool_gb = sum(g.capture_reserved_bytes or 0 for g in
                          engine._prefill_graphs.values()) / 1e9
    log(f"  memory: {held_gb:.2f} GB held from earlier phases at the start; "
        f"peak to the end of the load {load_peak_gb:.2f} GB, over the served "
        f"runs {serve_peak_gb:.2f} GB; {graph_gb:.2f} GB allocated with the "
        f"graphs alive, of which the decode graph's static tree "
        f"{static_gb:.3f} GB (the caches, max_len {MAX_LEN}, which the "
        f"prefill graph writes too); the decode graph's capture reserved "
        f"{pool_gb:.3f} GB for the pool, the "
        f"{len(engine._prefill_graphs)} prefill graph(s)' "
        f"{prefill_pool_gb:.3f} GB more")
    timings.update(rel_fro_pinned=rel_p, rel_fro_free=rel_f,
                   expert_choice_flips_free=flips_free,
                   expert_choices=n_choices, first_generate_ms=t_gen * 1e3,
                   k1_launches_by_body=bodies, k2_launches_by_body=bodies_k2,
                   prefill_counts=counts, prefill_dropped=dropped,
                   load_ms=t_load * 1e3, k5_load_launches_by_body=load_bodies,
                   peak_gb=peak_gb, load_peak_gb=load_peak_gb,
                   serve_peak_gb=serve_peak_gb, held_gb=held_gb,
                   allocated_with_graph_gb=graph_gb, graph_static_gb=static_gb,
                   graph_pool_reserved_gb=pool_gb,
                   prefill_graph_pool_reserved_gb=prefill_pool_gb)
    del engine
    torch.cuda.empty_cache()
    return load, launches, timings, check["logits"]


# Phase 7: the other eight configs of the registry, served at their
# published widths through Engine(pack_weights=True). Depth (layers served
# out of the config's) is the only cut, and only where one card's memory
# forces it: llama4-scout's f32 init plus its packed copy is about 12.5 GB a
# layer (16 experts), command-r-plus's about 9.4 GB (d_model 12288, d_ff
# 33792) beside a 12.6 GB f32 embedding.
FAMILY_DEPTH = {"qwen3-4b": None, "phi3-mini-3.8b": None,
                "llama4-scout-17b-a16e": 4, "command-r-plus-104b": 4,
                "mamba2-130m": None, "hymba-1.5b": None, "paligemma-3b": None,
                "whisper-base": None}
FAMILY_PROMPT, FAMILY_STEPS = (2, 64), 8
FAMILY_SEED = 20  # config i's weights; its prompt FAMILY_SEED + i + 100


def family_counts(cfg) -> dict:
    """K1 launches of one forward derived from the config (``prefill``,
    ``decode``: the LM head included once), K2's, and the dense weights
    the load packs (``pack_b``: the LM head included) and expert stacks
    (``pack_b_grouped``)."""
    layers = cfg.num_layers
    attn = 4 if cfg.has_attention else 0
    ssm = 2 if cfg.has_ssm else 0
    mlp = 0 if cfg.is_moe or not cfg.d_ff else (
        3 if cfg.mlp_type in ("swiglu", "geglu") else 2)
    per_layer = attn + ssm + mlp
    out = dict(prefill=per_layer * layers + 1, decode=per_layer * layers + 1,
               k2=2 * layers if cfg.is_moe else 0,
               pack_b=per_layer * layers + 1,
               pack_b_grouped=3 * layers if cfg.is_moe else 0)
    if cfg.is_encoder_decoder:
        # Encoder layers: attention + MLP; decoder layers: self attention,
        # cross attention (q, o a step; its k, v from the encoder's output
        # once, at prefill) and the MLP.
        enc = cfg.encoder_layers * (4 + mlp)
        out.update(prefill=enc + layers * (4 + 4 + mlp) + 1,
                   decode=layers * (4 + 2 + mlp) + 1,
                   pack_b=enc + layers * (4 + 4 + mlp) + 1)
    return out


def family_batch(torch, cfg, seed) -> dict:
    """The prompt (2 x 64 tokens) and, where the model takes them, the stub
    frontends' embeddings (paligemma's 256 patches, whisper's 1500 frames),
    N(0, 1) in bf16 on the card, drawn from ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    b, s = FAMILY_PROMPT
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((b, cfg.num_patches, cfg.d_model),
                                       generator=gen)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v).to(DEVICE)
            for k, v in batch.items()}


def family_config(cfgs, serve, arch) -> tuple:
    """(the published config, the served one: depth per FAMILY_DEPTH and
    bf16 compute, its ServeConfig: packed weights, bf16 caches and room for
    a VLM's prefix, the prompt and the steps; the prefix's length)."""
    full = cfgs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=FAMILY_DEPTH[arch] or full.num_layers,
                              compute_dtype="bfloat16")
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    scfg = serve.ServeConfig(max_len=prefix + FAMILY_PROMPT[1] + FAMILY_STEPS,
                             pack_weights=True, cache_dtype="bfloat16")
    return full, cfg, scfg, prefix


def packed_weights(params) -> tuple:
    """The distinct packed weights of a served tree: ({(K, N, format):
    (the first key path holding one, the PackedWeight)}, {(E, K, N, format):
    (path, the stack, its silu-gate partner or None)}) — an MoE subtree's
    wg / wu as one pair, its wo alone."""
    from repro_torch.core.layered import GroupedPackedWeight, PackedWeight
    dense, stacks = {}, {}
    # Depth first, in the tree's order, without a recursive closure (whose
    # reference cycle would keep the weights alive until the next gc pass).
    todo = [("", params)]
    while todo:
        path, tree = todo.pop()
        items = (tree.items() if isinstance(tree, dict) else
                 enumerate(tree) if isinstance(tree, list) else ())
        subtrees = []
        for key, w in items:
            at = f"{path}.{key}" if path else str(key)
            if isinstance(w, PackedWeight):
                dense.setdefault((w.k, w.n, w.fmt), (at, w))
            elif isinstance(w, GroupedPackedWeight):
                if key == "wu":
                    continue  # the partner of wg
                pair = tree["wu"] if key == "wg" else None
                stacks.setdefault((w.e, w.k, w.n, w.fmt, pair is not None),
                                  (at, w, pair))
            else:
                subtrees.append((at, w))
        todo.extend(reversed(subtrees))
    return dense, stacks


def served_shape_checks(torch, gp, gg, params, rows_k1, envelopes_k2,
                        seed) -> tuple:
    """K1 on each distinct packed [K, N] weight of the served tree (the
    attention, cross-attention, MLP and SSM projections of every stack, the
    encoder's included, and the LM head) at each row count of ``rows_k1``,
    and K2 on each distinct expert stack (the gate/up pair with its silu
    gate, the down projection) at each envelope C of ``envelopes_k2`` (one
    group: every phase-7 prompt fits in one), with ragged counts (one
    segment full, one empty, the rest drawn). Each call is held against its
    plain version on the same inputs at phase 1's tolerances (bf16 output
    2e-2 / 1e-3: f32 sums in other orders, one bf16 rounding), to the body
    it must take (k1_body / k2_body), and, for K2, rows at or past a count
    exactly 0. A is N(0, 1) in bf16, as a normed activation. Returns
    (failed tags, one row a weight: shape, the bodies it took by rows or C,
    the worst error)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    k1, k2 = gp.gemm_packed_fused_a, gg.gemm_grouped_packed_ragged
    dense, stacks = packed_weights(params)
    fails, rows = [], []

    def launch(fn, tag, call):
        before = dict(fn.variants)
        try:
            got = call()
            torch.cuda.synchronize()
        except RuntimeError as exc:  # a faulty kernel may fail its launch
            fails.append(tag)
            log(f"  check {tag}: {exc} FAIL")
            return None, []
        return got, [v for v, c in fn.variants.items() if c != before[v]]

    def judge(tag, row, key, ok, err, ran, body):
        ok = ok and ran == [body]
        row["bodies"][key] = "+".join(ran)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if not ok:
            fails.append(tag)
            log(f"  check {tag} [{'+'.join(ran)}; want {body}]: max_abs_err="
                f"{err:.3e} (rtol=2e-2, atol=1e-3) FAIL")

    for (k, n, fmt), (path, w) in dense.items():
        row = dict(kernel="K1", weight=path, k=k, n=n, bk=fmt.bk, bn=fmt.bn,
                   padded_n=-(-n // fmt.bn) * fmt.bn, bodies={}, max_abs_err=0.0)
        for m in rows_k1:
            a = torch.randn((m, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            kw = dict(bm=w._clamp_bm(m), b_format=fmt)
            tag = f"K1 {path} {k}x{n} M={m}"
            got, ran = launch(k1, tag, lambda: k1(a, w.packed, n, **kw))
            if got is None:
                continue
            ok, err = close(got, gp.gemm_packed_fused_a_plain(a, w.packed, n, **kw),
                            2e-2, 1e-3)
            judge(tag, row, f"m{m}", ok, err, ran, k1_body(m))
            del a, got
        rows.append(row)
    for (e, k, n, fmt, _), (path, w, pair) in stacks.items():
        row = dict(kernel="K2", weight=path + (" + wu, silu_gate" if pair else ""),
                   e=e, k=k, n=n, bodies={}, max_abs_err=0.0)
        for c in envelopes_k2:
            a = torch.randn((e, 1, c, k), generator=gen, device=DEVICE).to(
                torch.bfloat16)
            counts = torch.randint(0, c + 1, (e, 1), generator=gen, device=DEVICE,
                                   dtype=torch.int32)
            counts[0], counts[-1] = c, 0
            kw = dict(bm=w._clamp_bm(c), b_format=fmt)
            if pair is not None:
                kw.update(b2_packed=pair.packed, epilogue="silu_gate")
            tag = f"K2 {row['weight']} E={e} {k}x{n} C={c}"
            got, ran = launch(k2, tag, lambda: k2(a, w.packed, n, counts, **kw))
            if got is None:
                continue
            ok, err = close(got, gg.gemm_grouped_packed_ragged_plain(
                a, w.packed, n, counts, **kw), 2e-2, 1e-3)
            live = torch.arange(c, device=DEVICE)[None, None, :] < counts[..., None]
            ok = ok and not bool(got[~live].any())
            judge(tag, row, f"c{c}", ok, err, ran, k2_body(c))
            del a, got
        rows.append(row)
    return fails, rows


def phase_family(torch, gp, gg, counters, cfgs, models, serve, arch, seed,
                 card) -> tuple:
    """One config at its published widths (depth cut per FAMILY_DEPTH),
    random f32 weights from ``seed`` packed in bf16 at load, served through
    ``Engine.generate`` (2 x 64 prompt, 8 greedy steps): launches counted
    (K1 by body, K2 by body for an MoE), K1 and K2 against their plain
    versions on every distinct packed weight at the rows the path gives
    them (served_shape_checks), prefill logits against the plain versions
    on the card, and the decode graph against the eager loop
    (``graph_against_eager``). Returns (load launches, generate launches,
    results)."""
    from repro_torch.models import moe
    from repro_torch.serve import graphs
    full, cfg, scfg, prefix = family_config(cfgs, serve, arch)
    depth = cfg.num_layers
    want = family_counts(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.build(cfg, device=DEVICE)
    params = model.init(seed)
    counters.reset()
    t_load = time.perf_counter()
    engine = serve.Engine(model, params, scfg, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_load
    del params
    torch.cuda.empty_cache()
    load = counters.read()
    load_bodies = {name: launches_by_body(counters, name)
                   for name in ("pack_b", "pack_b_grouped")}
    want_load = counters.only(pack_b=want["pack_b"],
                              pack_b_grouped=want["pack_b_grouped"])
    cut = ("full depth" if depth == full.num_layers else
           f"{depth} of {full.num_layers} layers (depth the only cut, forced "
           f"by memory)")
    log(f"  {arch}: {cut}, d_model {cfg.d_model}, heads {cfg.num_heads} / "
        f"{cfg.num_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, family {cfg.family}"
        + (f", ssm d_inner {cfg.d_inner} state {cfg.ssm_state_size} heads "
           f"{cfg.ssm_num_heads}" if cfg.has_ssm else "")
        + (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok}"
           if cfg.is_moe else "")
        + (f", window {cfg.sliding_window}" if cfg.sliding_window else "")
        + (f", parallel block" if cfg.parallel_block else "")
        + f"; init + pack {time.perf_counter() - t0:.1f} s (load, synchronized, "
        f"{t_load * 1e3:.1f} ms), peak {torch.cuda.max_memory_allocated() / 1e9:.1f}"
        f" GB, served {torch.cuda.memory_allocated() / 1e9:.1f} GB; load launches "
        f"{ {k: v for k, v in load.items() if v} } (want pack_b "
        f"{want['pack_b']}, pack_b_grouped {want['pack_b_grouped']}); K5 by body "
        f"{load_bodies}")
    if load != want_load:
        raise AssertionError(f"{arch}: load-time launch counts {load}")
    batch = family_batch(torch, cfg, seed + 100)

    # -- the main path, counted -------------------------------------------
    counters.reset()
    t0 = time.perf_counter()
    tokens = engine.generate(batch, max_new_tokens=FAMILY_STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = counters.read()
    bodies = launches_by_body(counters)
    bodies_k2 = launches_by_body(counters, "gemm_grouped_packed_ragged")
    # Every projection of the prefill has more than 16 rows (wgmma); the
    # prefill's LM head (2 last positions) and every decode step's
    # contractions have 2 (tc_stream). Every shape is bk 128 x bn 64 tiles
    # on 16-byte aligned operands, odd N (mamba2's in_proj 3352, hymba's
    # 6496, the vocabularies) included: the TMA bodies take them.
    want_bodies = dict(wgmma=want["prefill"] - 1,
                       tc_stream=1 + want["decode"] * FAMILY_STEPS)
    want_k1 = want["prefill"] + want["decode"] * FAMILY_STEPS
    want_k2 = want["k2"] * (FAMILY_STEPS + 1)
    want_bodies_k2, envelopes = {}, []
    if cfg.is_moe:
        tokens_pre = FAMILY_PROMPT[0] * FAMILY_PROMPT[1]
        for rows, calls in ((tokens_pre, want["k2"]),
                            (FAMILY_PROMPT[0], want["k2"] * FAMILY_STEPS)):
            c = moe._capacity(min(moe.GROUP_SIZE, rows), cfg)
            envelopes.append(c)
            body = k2_body(c)
            want_bodies_k2[body] = want_bodies_k2.get(body, 0) + calls
    log(f"  generate {FAMILY_PROMPT[0]}x{FAMILY_PROMPT[1]}"
        + (f" + {prefix} patches" if prefix else "")
        + (f" + {cfg.encoder_seq} frames" if cfg.is_encoder_decoder else "")
        + f" + {FAMILY_STEPS} steps: {t_gen * 1e3:.1f} ms; launches "
        f"{ {k: v for k, v in launches.items() if v} } (want K1 {want['prefill']} "
        f"+ {want['decode']} x {FAMILY_STEPS} = {want_k1}, K2 {want_k2}); K1 by "
        f"body {bodies} (want {want_bodies}); K2 by body {bodies_k2} (want "
        f"{want_bodies_k2})")
    if launches != counters.only(gemm_packed_fused_a=want_k1,
                                 gemm_grouped_packed_ragged=want_k2):
        raise AssertionError(f"{arch}: launch counts {launches}")
    if bodies != want_bodies or bodies_k2 != want_bodies_k2:
        raise AssertionError(f"{arch}: launches by body {bodies} / {bodies_k2}")
    if tokens.shape != (FAMILY_PROMPT[0], FAMILY_STEPS) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: bad tokens {tokens.shape}")
    log(f"  tokens[0] = {tokens[0].tolist()}")
    graphed = engine._graphed
    if graphed:
        graph_check = graph_against_eager(torch, counters, engine, batch,
                                          FAMILY_STEPS, arch)
        # Held against a replay's kernel records in the timing process.
        graph_check["credit_by_class"] = credit_by_class(
            decode_graph(engine, FAMILY_PROMPT[0]).credit)
        # The prefill's graph, captured by graph_against_eager's run, against
        # the eager prefill (bitwise); timed and held to its records in the
        # timing process, against this credit.
        *equal, step = prefill_graph_bitwise(torch, engine, batch)
        graph_check.update(prefill_logits_bitwise_equal=equal[0],
                           prefill_caches_bitwise_equal=equal[1],
                           prefill_replays=step.replays,
                           prefill_capture_ms=step.capture_ms,
                           prefill_credit_by_class=credit_by_class(step.credit))
        log(f"  {arch}, the prefill graph ({step.replays} replays): logits "
            f"bitwise the eager prefill's {equal[0]}, caches {equal[1]}; "
            f"capture {step.capture_ms:.1f} ms")
        if not all(equal) or step.graph is None:
            raise AssertionError(f"{arch}: the prefill graph differs from the "
                                 f"eager prefill")
    else:
        graph_check = dict(eager=graphs.eager_reason(cfg))
        log(f"  {arch}: decode eager on the card: {graph_check['eager']}")

    # -- K1 / K2 at the served shapes against their plain versions ---------
    # The rows the path gives K1: 2 (decode, the prefill's LM head), the
    # prefill's tokens (the VLM's prefix included) and whisper's encoder
    # frames.
    b, s = FAMILY_PROMPT
    rows_k1 = sorted({b, b * (prefix + s)}
                     | ({b * cfg.encoder_seq} if cfg.is_encoder_decoder else set()))
    t0 = time.perf_counter()
    shape_fails, shape_rows = served_shape_checks(
        torch, gp, gg, engine.params, rows_k1, envelopes, seed + 200)
    t_checks = time.perf_counter() - t0
    odd = {f"{r['weight']} {r['k']}x{r['n']}": r for r in shape_rows
           if r["kernel"] == "K1" and r["n"] % r["bn"]}
    log(f"  served shapes vs plain ({t_checks:.1f} s): "
        f"{sum(len(r['bodies']) for r in shape_rows)} calls on "
        f"{len(shape_rows)} weights, worst max_abs_err "
        f"{max(r['max_abs_err'] for r in shape_rows):.3e}, "
        f"{'ok' if not shape_fails else f'{len(shape_fails)} FAIL'}")
    for r in shape_rows:
        shape = (f"E={r['e']} {r['k']}x{r['n']}" if r["kernel"] == "K2" else
                 f"{r['k']}x{r['n']}" + (f" (N padded to {r['padded_n']} on bn "
                                        f"{r['bn']})" if r["n"] % r["bn"] else ""))
        log(f"    {r['kernel']} {r['weight']} {shape}: bodies {r['bodies']}, "
            f"max_abs_err {r['max_abs_err']:.3e}")
    if shape_fails:
        raise AssertionError(f"{arch}: kernels disagree with their plain "
                             f"versions at served shapes: {shape_fails}")

    # -- prefill logits against the plain versions on the card -------------
    if cfg.is_moe:
        # Routing pinned (the gate) and free, expert-choice flips reported.
        verdict = mixtral_prefill_check(torch, gp, gg, engine, batch["tokens"],
                                        cfg)
        logits_k = verdict.pop("logits")
    else:
        logits_k, _ = engine._prefill(batch)
        with plain_kernels(gp, None):
            logits_p, _ = engine._prefill(batch)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits_k).all()):
            raise AssertionError(f"{arch}: non-finite logits")
        rel, max_err, same = compare_logits(torch, logits_k, logits_p)
        verdict = dict(rel_fro=rel, max_abs_err=max_err, same_argmax=same)
        log(f"  prefill logits kernel vs plain: rel_fro={rel:.3e} (limit 5e-2), "
            f"max_abs_err={max_err:.3e}, |logits|max="
            f"{float(logits_p.abs().max()):.3f}, same argmax {same}/"
            f"{FAMILY_PROMPT[0]}")
        if rel > 5e-2:
            raise AssertionError(f"{arch}: served logits disagree with the "
                                 f"plain version")
        del logits_p
    del logits_k
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {arch}: peak {peak:.1f} GB; card {card}")
    del engine, model, batch
    torch.cuda.empty_cache()
    return load, launches, dict(
        arch=arch, layers=depth, published_layers=full.num_layers,
        first_generate_ms=t_gen * 1e3, load_ms=t_load * 1e3, peak_gb=peak,
        k1_launches_by_body=bodies, k2_launches_by_body=bodies_k2,
        k1_per_forward=dict(prefill=want["prefill"], decode=want["decode"]),
        k5_load_launches_by_body=load_bodies, served_shapes=shape_rows,
        odd_n=odd, card=card, tokens0=tokens[0].tolist(),
        graph_check=graph_check, **verdict)


FAMILY_TIMES_TAG = "phase 7 times: "


def family_graph_times(torch, engine, caches, tok, pos0) -> dict:
    """Phase 7's decode step as served: a replay of its captured graph (the
    token copy, the position fill and the replay), in CUDA events over
    FAMILY_STEPS // 2 replays and profiled over one, and the capture's ms.
    Nothing of the graph outlives the call but the engine's own."""
    graph = engine._decode_graph(caches, FAMILY_PROMPT[0])
    graph({"caches": caches, "tok": tok, "pos": pos0})

    def replay(i):
        graph({"tok": tok, "pos": pos0 + i % FAMILY_STEPS})
    ms = time_ms(replay, FAMILY_STEPS // 2)
    counts = {}
    dev, kept, _ = profile_kernels(torch, replay, 1, counts)
    busy = sum(dev.values()) / 1e3
    arch = engine.model.cfg.name
    return dict(graph_decode_ms_per_step=ms, graph_decode_busy_ms=busy,
                graph_decode_busy_share=busy / ms,
                graph_capture_ms=graph.capture_ms, graph_records_kept=kept,
                replay_records=replay_launch_check(
                    lambda: kernel_counts(torch, replay, 1), graph.credit, 1,
                    f"{arch}, the decode graph", counts))


def family_prefill_graph_times(torch, engine, batch) -> dict:
    """Phase 7's prefill as served: its graph (the first call the eager
    warm-up, the second the capture) against the eager prefill. A replay's
    logits and caches bitwise the eager prefill's, else the run fails; the graph's
    call (the input copy and the replay) and the replay alone in CUDA
    events (2 calls), the replay profiled once: its device busy share
    against the replay alone, and its kernel records, which phase 7's main
    process holds to its own graph's credit."""
    equal, caches_equal, step = prefill_graph_bitwise(torch, engine, batch)
    arch = engine.model.cfg.name
    if not (equal and caches_equal) or step.graph is None:
        raise AssertionError(f"{arch}: the prefill graph's logits differ from "
                             f"the eager prefill's")
    ms = time_ms(lambda i: engine._graphed_prefill(batch), 2)
    replay_ms = time_ms(lambda i: step.graph.replay(), 2)
    counts = {}
    dev, kept, _ = profile_kernels(torch, lambda i: step.graph.replay(), 1,
                                   counts)
    busy = sum(dev.values()) / 1e3
    return dict(prefill_graph_ms=ms, prefill_replay_ms=replay_ms,
                prefill_graph_busy_ms=busy,
                prefill_graph_busy_share=busy / replay_ms,
                prefill_graph_records_kept=kept,
                prefill_logits_bitwise_equal=equal,
                prefill_capture_ms=step.capture_ms,
                prefill_replay_records=replay_launch_check(
                    lambda: kernel_counts(torch, lambda i: step.graph.replay(), 1),
                    step.credit, 1, f"{arch}, the prefill graph", counts))


# The configs whose prefill error is traced layer by layer in phase 7's
# timing process: the two nearest the 5e-2 gate and one far below it.
LAYER_CURVE_ARCHS = ("phi3-mini-3.8b", "hymba-1.5b", "whisper-base")


def prefill_stages(torch, cfg, params, batch) -> tuple:
    """The served prefill (no caches kept) as stages, each
    ``fn(state) -> state`` over a state (x, the encoder's output or None):
    each layer (an encoder-decoder's encoder layers, its encoder's output,
    then its decoder layers), then the final norm and the last position's
    logits. Returns (the first state, [(name, fn, the component of the
    state it writes: 0 or 1)])."""
    import functools

    from repro_torch.core.dtypes import torch_dtype
    from repro_torch.models import attention as attn
    from repro_torch.models import encdec, transformer
    from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                           lm_logits)
    compute = torch_dtype(cfg.compute_dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)

    def logits(state):
        x = apply_norm(cfg, params["final_norm"], state[0])
        return lm_logits(cfg, params, x[:, -1:])[:, 0], state[1]
    stages = []
    if not cfg.is_encoder_decoder:
        def layer(p, state):
            return transformer.prefill_block(cfg, p, state[0], positions, 0)[0], None
        stages += [(f"layer {i}", functools.partial(layer, p), 0)
                   for i, p in enumerate(params["layers"])]
        return ((embed_tokens(cfg, params, tokens, compute), None),
                stages + [("logits", logits, 0)])

    def enc_layer(lp, state):
        c = state[0]
        h = apply_norm(cfg, lp["norm1"], c)
        c = c + attn.self_attention(cfg, lp["attn"], h, positions=None,
                                    causal=False)
        return c + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm2"], c)), None

    def enc_out(state):
        x = encdec._with_positions(cfg, embed_tokens(cfg, params, tokens,
                                                     compute))
        return x, apply_norm(cfg, params["encoder"]["final_norm"], state[0])

    def dec_layer(lp, state):
        ck, cv = attn.encode_kv(cfg, lp["xattn"], state[1])
        return encdec._dec_block(cfg, lp, state[0], ck, cv, positions)[0], state[1]
    stages += [(f"encoder {i}", functools.partial(enc_layer, lp), 0)
               for i, lp in enumerate(params["encoder"]["layers"])]
    stages.append(("encoder out", enc_out, 1))
    stages += [(f"decoder {i}", functools.partial(dec_layer, lp), 0)
               for i, lp in enumerate(params["layers"])]
    first = encdec._with_positions(cfg, batch["frames"].to(compute))
    return (first, None), stages + [("logits", logits, 0)]


def prefill_layer_errors(torch, gp, engine, batch) -> dict:
    """The served prefill, stage by stage (``prefill_stages``), on the
    kernels against the plain versions (``plain_kernels``) on the card:
    ``drift``, each stage's relative Frobenius error with the two paths run
    apart from the same embedding (what the logits gate reads at the end),
    and ``local``, the error one stage adds: the stage on the kernels over
    the plain path's state before it, against the plain path's state
    after it."""
    cfg, params = engine.model.cfg, engine.params
    first, stages = prefill_stages(torch, cfg, params, batch)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def run(plain):
        states, state = [], first
        with (plain_kernels(gp, None) if plain else contextlib.nullcontext()), \
                torch.inference_mode():
            for _, fn, _ in stages:
                state = fn(state)
                states.append(state)
        return states
    kernel, plain = run(False), run(True)
    local = []
    with torch.inference_mode():
        for i, (_, fn, part) in enumerate(stages):
            got = fn(plain[i - 1] if i else first)
            local.append(rel(got[part], plain[i][part]))
    drift = [rel(k[part], p[part]) for k, p, (_, _, part) in
             zip(kernel, plain, stages)]
    return dict(stages=[name for name, _, _ in stages], drift=drift,
                local=local)


def family_times_main() -> int:
    """Phase 7's times, in a process of their own that phase_families
    starts: late in the smoke's process torch.profiler loses its kernel
    records (phase 6's timer check reads 0 of 5), so the device's busy time
    is read in a fresh one. For each config of FAMILY_DEPTH, the weights
    and prompt of phase 7 (same seeds): the prefill forward (2 calls) and a
    decode step (4 steps) in CUDA events, then torch.profiler over 1
    prefill forward and 1 decode step: device busy ms and its share of
    the unprofiled forward, with the kernel records kept (the process's
    first profile can miss the host's launch calls: on an H100 it has
    counted 144 beside qwen3-4b's 7658 kernel records). The same for the
    decode step as served, a replay of its captured graph (4 replays in
    events, 1 profiled), and the capture's ms; a family that
    ``serve.graphs.EAGER_FAMILIES`` names is reported as eager with its
    reason. Prints one line, FAMILY_TIMES_TAG + a JSON object {arch:
    times}."""
    import torch
    from repro_torch import configs as cfgs
    from repro_torch import models, serve
    from repro_torch.kernels import gemm_packed as gp
    from repro_torch.serve import graphs
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for i, arch in enumerate(FAMILY_DEPTH):
        t0 = time.perf_counter()
        _, cfg, scfg, prefix = family_config(cfgs, serve, arch)
        model = models.build(cfg, device=DEVICE)
        engine = serve.Engine(model, model.init(FAMILY_SEED + i), scfg,
                              device=DEVICE)
        torch.cuda.empty_cache()
        batch = family_batch(torch, cfg, FAMILY_SEED + i + 100)
        ms_prefill = time_ms(lambda i: engine._prefill(batch), 2)
        _, caches = engine._prefill(batch)
        tok = torch.zeros((FAMILY_PROMPT[0], 1), dtype=torch.long, device=DEVICE)
        pos0 = prefix + FAMILY_PROMPT[1]

        def step(i):
            pos = torch.full((FAMILY_PROMPT[0],), pos0 + i % FAMILY_STEPS,
                             dtype=torch.long, device=DEVICE)
            engine._decode(caches, tok, pos)
        ms_decode = time_ms(step, FAMILY_STEPS // 2)
        # One profiled call each: the profiler's processing of a call's
        # records takes longer than the call (busy repeats within 1%).
        dev_p, kept_p, _ = profile_kernels(torch, lambda i: engine._prefill(batch), 1)
        dev_d, kept_d, _ = profile_kernels(torch, step, 1)
        busy_p, busy_d = sum(dev_p.values()) / 1e3, sum(dev_d.values()) / 1e3
        out[arch] = dict(prefill_ms=ms_prefill, decode_ms_per_step=ms_decode,
                         prefill_busy_ms=busy_p, prefill_busy_share=busy_p / ms_prefill,
                         prefill_records_kept=kept_p, decode_busy_ms=busy_d,
                         decode_busy_share=busy_d / ms_decode,
                         decode_records_kept=kept_d)
        graph_line = ""
        if engine._graphed:
            out[arch].update(family_graph_times(torch, engine, caches, tok,
                                                pos0))
            t = out[arch]
            graph_line = (f"; graph replay {t['graph_decode_ms_per_step']:.3f} "
                          f"ms/step, device busy {t['graph_decode_busy_ms']:.3f} "
                          f"ms ({100 * t['graph_decode_busy_share']:.1f}%, "
                          f"records kept {t['graph_records_kept']}), capture "
                          f"{t['graph_capture_ms']:.1f} ms")
            out[arch].update(family_prefill_graph_times(torch, engine, batch))
            graph_line += (
                f"; prefill graph {t['prefill_graph_ms']:.2f} ms as served, "
                f"replay {t['prefill_replay_ms']:.2f} ms, device busy "
                f"{t['prefill_graph_busy_ms']:.3f} ms "
                f"({100 * t['prefill_graph_busy_share']:.1f}% of the replay, "
                f"records kept {t['prefill_graph_records_kept']}), logits "
                f"bitwise the eager prefill's {t['prefill_logits_bitwise_equal']}"
                f", capture {t['prefill_capture_ms']:.1f} ms")
        else:
            out[arch]["graph"] = graph_line = (
                f"; decode eager on the card: "
                f"{graphs.eager_reason(cfg)}")
        log(f"  {arch}: prefill {ms_prefill:.2f} ms, device busy {busy_p:.3f} ms "
            f"({100 * busy_p / ms_prefill:.1f}%, records kept {kept_p}); decode "
            f"eager {ms_decode:.3f} ms/step (batch {FAMILY_PROMPT[0]}), device "
            f"busy {busy_d:.3f} ms ({100 * busy_d / ms_decode:.1f}%, records "
            f"kept {kept_d}){graph_line}; {time.perf_counter() - t0:.1f} s")
        if arch in LAYER_CURVE_ARCHS:
            t1 = time.perf_counter()
            curve = out[arch]["layer_errors"] = prefill_layer_errors(
                torch, gp, engine, batch)
            local = sorted(curve["local"][:-1])
            log(f"  {arch}: prefill layer by layer, kernels against the plain "
                f"versions (relative Frobenius; {time.perf_counter() - t1:.1f} s)"
                f": the logits {curve['drift'][-1]:.3e} apart (the gate: 5e-2); "
                f"largest error one stage adds {local[-1]:.3e}, median "
                f"{local[len(local) // 2]:.3e}")
            for name, d, l_ in zip(curve["stages"], curve["drift"],
                                   curve["local"]):
                log(f"    {name:>12}: apart {d:.3e}, added {l_:.3e}")
        del caches, engine, model, batch, step
        torch.cuda.empty_cache()
    from repro_torch.core import health
    assert_healthy(health, "phase 7's timing process")
    log(FAMILY_TIMES_TAG + json.dumps(out))
    return 0


def phase_families(torch, gp, gg, counters, cfgs, models, serve, card) -> tuple:
    """Phase 7: every config of FAMILY_DEPTH in turn, each freed before the
    next; then their times in a fresh process (family_times_main). Returns
    ({path: load launches, path: launches}, results, seconds)."""
    paths, results = {}, {}
    t_phase = time.perf_counter()
    for i, arch in enumerate(FAMILY_DEPTH):
        t0 = time.perf_counter()
        load, launches, res = phase_family(torch, gp, gg, counters, cfgs,
                                           models, serve, arch, FAMILY_SEED + i,
                                           card)
        res["seconds"] = time.perf_counter() - t0
        paths[f"{arch} packed, load"] = load
        paths[f"{arch} packed"] = launches
        results[arch] = res
    log("  times, in a fresh process (torch.profiler keeps its records there):")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.family_times_main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    for line in lines:
        if not line.startswith(FAMILY_TIMES_TAG):
            log(line)
    times = [ln for ln in lines if ln.startswith(FAMILY_TIMES_TAG)]
    if run.returncode != 0 or len(times) != 1:
        log(run.stderr[-4000:])
        raise AssertionError(f"phase 7's timing process failed (exit "
                             f"{run.returncode})")
    for arch, t in json.loads(times[0][len(FAMILY_TIMES_TAG):]).items():
        results[arch].update(t)
        # This process's graph credits what the timing process's replay of
        # the same config's graph was measured to launch.
        for what, key in (("decode", ""), ("prefill", "prefill_")):
            credited = results[arch]["graph_check"].get(key + "credit_by_class")
            if credited is not None and credited != t.get(key + "replay_records"):
                raise AssertionError(
                    f"{arch}: the {what} graph credits {credited} a replay; a "
                    f"replay in the timing process launched "
                    f"{t.get(key + 'replay_records')}")
    log(f"  timing process {time.perf_counter() - t0:.1f} s; card {card}")
    seconds = time.perf_counter() - t_phase
    log(json.dumps({"families": results, "phase_s": seconds, "card": card}))
    log(f"  phase 7 took {seconds:.1f} s")
    return paths, results, seconds


# Phase 8: training. Full-width olmo-1b through the launcher's entry point
# (``launch.train.main``): bf16 compute over f32 masters, a 4 x 512 Markov
# batch a step, 6 steps, remat. The checkpoint round trip runs at the same
# widths with the depth cut to CKPT_LAYERS of 16 (a full f32 state with
# both Adam moments is about 14 GB to write).
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
TRAIN_ARGS = ["--arch", TRAIN_ARCH, "--preset", "full", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--data", "markov",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
CKPT_LAYERS = 2
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-2, 5e-2   # (b): loss, each leaf's rel. Frobenius
TRAIN_TIMES_TAG = "phase 8 times: "
TRAIN_KERNELS = ("gemm_packed_fused_a", "pack_b", "gemm_tiled")


def train_products(cfg, tokens, remat=True) -> list:
    """The dense products of one train step of a dense config, as (M, K,
    N, B a transposed view, A a transposed view, count): for each
    contraction (q, k, v, o, the MLP's projections a layer, the LM head)
    the forward (again for the layers under remat), dX = g @ W^T and dW =
    X^T @ g."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = ([(d, f), (d, f), (f, d)] if cfg.mlp_type in ("swiglu", "geglu")
           else [(d, f), (f, d)])
    layer = [(d, cfg.q_dim), (d, cfg.kv_dim), (d, cfg.kv_dim),
             (cfg.q_dim, d)] + mlp
    out = []
    for k, n in layer:
        out += [(tokens, k, n, False, False, cfg.num_layers * (2 if remat else 1)),
                (tokens, n, k, True, False, cfg.num_layers),
                (k, tokens, n, False, True, cfg.num_layers)]
    v = cfg.vocab_size
    return out + [(tokens, d, v, True, False, 1), (tokens, v, d, False, False, 1),
                  (d, tokens, v, False, True, 1)]


def product_bodies(cfg, m, k, n, b_view, a_view) -> dict:
    """{kernel: body} of one train-step product (a row of
    ``train_products``) on the planner's pick (``choose_strategy``) for its
    (M, K, N). K1 takes ``wgmma`` (every product has more than 16 rows)
    after K5 packs its B: ``tma_copy`` for B as it lies, ``tma_stage`` for
    a transposed view (the head's ``table.t()`` forward, every layer
    weight's W^T in dX; the head's W^T is the table itself; a K1 dW reads
    X^T made contiguous). K7, where the planner picks ``tiling``, takes
    ``wgmma`` on operands as they lie and ``mma_general`` for dW's
    transposed X^T."""
    from repro_torch.core.planner import choose_strategy
    if choose_strategy(m, k, n, cfg.compute_dtype) == "tiling_packing_fused":
        return {"gemm_packed_fused_a": "wgmma",
                "pack_b": "tma_stage" if b_view else "tma_copy"}
    return {"gemm_tiled": "mma_general" if a_view else "wgmma"}


def train_step_counts(cfg, tokens, remat=True) -> dict:
    """Launches of one train step of a dense config by kernel and body,
    derived from the config: each product of ``train_products`` on the
    bodies ``product_bodies`` names, times its count."""
    out = {"gemm_packed_fused_a": {}, "pack_b": {}, "gemm_tiled": {}}
    for m, k, n, b_view, a_view, count in train_products(cfg, tokens, remat):
        for kernel, body in product_bodies(cfg, m, k, n, b_view,
                                           a_view).items():
            out[kernel][body] = out[kernel].get(body, 0) + count
    return out


def train_step_bounds(cfg, tokens) -> dict:
    """The least device ms of one train step's GEMMs (``bound_ms`` of each
    product in bf16, summed with its count) and of its packs (each B read
    once and its tiles written once, in bf16, at the HBM rate)."""
    gemm_ms, pack_bytes, by = 0.0, 0, set()
    for m, k, n, _, _, count in train_products(cfg, tokens):
        ms, why = bound_ms(m, k, n, 2, 2 * k * n, 2, H100_BF16_FLOPS)
        gemm_ms += count * ms
        by.add(why)
        pack_bytes += count * 2 * (2 * k * n)
    return {"gemm_bound_ms": gemm_ms, "gemm_bound_by": "/".join(sorted(by)),
            "pack_bound_ms": 1e3 * pack_bytes / H100_HBM_BYTES}


def train_launches(counters) -> dict:
    """The counters' launches by body of the kernels training runs, and
    the total of every other wrapper (must be 0)."""
    v = counters.variants()
    out = {name: {b: c for b, c in v[name].items() if c}
           for name in TRAIN_KERNELS}
    out["others"] = sum(c for name, c in counters.read().items()
                        if name not in TRAIN_KERNELS)
    return out


def train_shape_checks(torch, counters, cfg, tokens, seed=8) -> tuple:
    """Each distinct product of one train step (``train_products``) on the
    card, through the calls the step makes at the shape it makes them:
    ``gemm.matmul`` for the forward and dX (B as the step hands it: W as
    it lies, or a transposed view for the head's ``table.t()`` and every
    W^T), ``core.autograd.weight_grad`` for dW = X^T @ g. Each is held
    against torch.matmul in f32 (TF32 off) on the same bf16 inputs,
    rounded to bf16, at phase 1's tolerances (2e-2 / 1e-3: f32 sums in
    other orders, one bf16 rounding), and its launches to the bodies
    ``product_bodies`` names, once each and nothing else. A is N(0, 1)
    and B N(0, 1 / K) in bf16, so every output is of unit scale, the
    scale phase 1's atol is set for (a normed activation against weights
    at their init std, 0.02 at K 2048): at N(0, 1) operands an output
    near 0 carries f32 rounding of partial sums up to sqrt(K) in size,
    which an atol of 1e-3 cannot hold at K 8192 on any f32 GEMM. Returns
    (failed tags, one row a product)."""
    from repro_torch.core import autograd as ag
    from repro_torch.core import gemm
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=DEVICE) * std).to(bf16)

    fails, rows = [], []
    seen = set()
    for m, k, n, b_view, a_view, _ in train_products(cfg, tokens):
        if (m, k, n, b_view, a_view) in seen:
            continue
        seen.add((m, k, n, b_view, a_view))
        kind = "dW" if a_view else ("fwd/dX, B^T view" if b_view else "fwd/dX")
        if a_view:   # dW = X^T @ g: X [tokens, m], g [tokens, n]
            x, g = randn(k, m), randn(k, n, std=k ** -0.5)
            a_f32, b_f32 = x.float().t(), g.float()
            call = lambda: ag.weight_grad(x, g, out_dtype=bf16)
        else:
            a = randn(m, k)
            b = (randn(n, k, std=k ** -0.5).t() if b_view
                 else randn(k, n, std=k ** -0.5))
            a_f32, b_f32 = a.float(), b.float()
            call = lambda: gemm.matmul(a, b)
        counters.reset()
        got = call()
        torch.cuda.synchronize()
        ran = train_launches(counters)
        want = {kern: {} for kern in TRAIN_KERNELS}
        for kern, body in product_bodies(cfg, m, k, n, b_view, a_view).items():
            want[kern] = {body: 1}
        want["others"] = 0
        ok, err = close(got, (a_f32 @ b_f32).to(bf16), 2e-2, 1e-3)
        tag = f"{kind} M={m} K={k} N={n}"
        bodies = ", ".join(f"{kern} {b}" for kern in TRAIN_KERNELS
                           for b in ran[kern])
        rows.append(dict(product=kind, m=m, k=k, n=n, bodies=bodies,
                         max_abs_err=err, ok=ok and ran == want))
        if not rows[-1]["ok"]:
            fails.append(tag)
            log(f"  check {tag} [{bodies}; want {want}]: max_abs_err="
                f"{err:.3e} (rtol=2e-2, atol=1e-3) FAIL")
        del got, a_f32, b_f32
    torch.cuda.empty_cache()
    log(f"  step products at their shapes: {len(rows) - len(fails)} of "
        f"{len(rows)} held to torch.matmul (2e-2 / 1e-3) on their bodies; "
        f"largest error {max(r['max_abs_err'] for r in rows):.3e}")
    return fails, rows


def named_leaves(tree, prefix=""):
    """[(name, tensor)] of a params tree, per-layer lists indexed."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def train_grad_gate(torch, counters, models, cfg, batch) -> dict:
    """(b) One batch, the same weights: the loss and every leaf's gradient
    through the kernels (auto dispatch: K5 + K1) against the same step
    with every dense contraction on ``torch_matmul``, named through
    REPRO_TORCH_GEMM_STRATEGY. Also the launches of one step's forward and
    backward by body, against ``train_step_counts``."""
    from repro_torch.train import loop
    model = models.build(cfg, device=DEVICE)
    params = model.init(0)
    grads_fn = loop._grads_fn(model, loop.TrainConfig())
    counters.reset()
    g_k, m_k = grads_fn(params, batch)
    torch.cuda.synchronize()
    step_counts = train_launches(counters)
    want = train_step_counts(cfg, TRAIN_BATCH * TRAIN_SEQ)
    if {k: step_counts[k] for k in TRAIN_KERNELS} != want or step_counts["others"]:
        raise AssertionError(f"phase 8: one step launched {step_counts}, "
                             f"derived {want}")
    with env_set("REPRO_TORCH_GEMM_STRATEGY", "torch_matmul"):
        counters.reset()
        g_t, m_t = grads_fn(params, batch)
        torch.cuda.synchronize()
        plain_launched = sum(counters.read().values())
    if plain_launched:
        raise AssertionError(f"phase 8 (b): the torch_matmul step launched "
                             f"{plain_launched} kernels")
    loss_k, loss_t = float(m_k["loss"]), float(m_t["loss"])
    loss_rel = abs(loss_k - loss_t) / abs(loss_t)
    errs = {}
    for (name, gk), (_, gt_) in zip(named_leaves(g_k), named_leaves(g_t)):
        den = float(gt_.double().norm())
        errs[name] = float((gk.double() - gt_.double()).norm()) / max(den, 1e-30)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"  (b) gradient gate: loss kernels {loss_k:.6f} torch_matmul "
        f"{loss_t:.6f} (rel {loss_rel:.2e}, limit {TRAIN_LOSS_RTOL}); "
        f"{len(errs)} leaves, largest rel. Frobenius errors " +
        ", ".join(f"{n} {e:.2e}" for n, e in worst) +
        f" (limit {TRAIN_GRAD_RTOL})")
    if loss_rel > TRAIN_LOSS_RTOL or worst[0][1] > TRAIN_GRAD_RTOL:
        raise AssertionError("phase 8 (b): gradients through the kernels "
                             "disagree with torch_matmul's")
    del g_k, g_t, params, model
    torch.cuda.empty_cache()
    return dict(step_launches=step_counts, derived=want, loss=loss_k,
                loss_torch_matmul=loss_t, loss_rel=loss_rel,
                grad_rel_fro_max=worst[0][1], grad_rel_fro_worst=dict(worst),
                leaves=len(errs))


def train_ckpt_round_trip(torch, models, cfg, data) -> dict:
    """(c) At CKPT_LAYERS of the config's layers: 2 steps, save, 2 more;
    restore into fresh trees: the state bitwise the saved one, and the
    same 2 steps from it (the restored trees copied into the graphed
    step's static tree) give the same losses, bit for bit."""
    import shutil
    import tempfile
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import TrainConfig, make_train_step
    cut = dataclasses.replace(cfg, num_layers=CKPT_LAYERS)
    model = models.build(cut, device=DEVICE)
    step = make_train_step(model, TrainConfig(optim=opt.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=4)))
    batches = [launch.device_batch(data.batch_at(i), DEVICE) for i in range(4)]
    p = model.init(0)
    s = opt.init_state(p)
    for i in range(2):
        p, s, _ = step(p, s, batches[i])
    # A copy: the step writes its trees in place, the next steps included.
    saved = opt.tree_map(torch.clone, {"params": p, "opt": s})
    tmp = tempfile.mkdtemp(prefix="phase8_ckpt_")
    try:
        t0 = time.perf_counter()
        ckpt.save(tmp, 2, saved)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, n)) for n in os.listdir(tmp))
        straight = []
        for i in (2, 3):
            p, s, m = step(p, s, batches[i])
            straight.append(float(m["loss"]))
        template = {"params": model.init(1), "opt": opt.init_state(model.init(1))}
        t0 = time.perf_counter()
        restored, at = ckpt.restore(tmp, template)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same_state = at == 2 and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for (_, a), (_, b) in zip(named_leaves(saved), named_leaves(restored)))
    p, s = restored["params"], restored["opt"]
    resumed = []
    for i in (2, 3):
        p, s, m = step(p, s, batches[i])
        resumed.append(float(m["loss"]))
    out = dict(layers=CKPT_LAYERS, checkpoint_bytes=nbytes, save_s=save_s,
               restore_s=restore_s, state_bitwise=same_state,
               straight_losses=straight, resumed_losses=resumed,
               losses_bitwise=straight == resumed)
    log(f"  (c) checkpoint at {CKPT_LAYERS} of {cfg.num_layers} layers: "
        f"{nbytes / 1e9:.2f} GB, save {save_s:.1f} s, restore {restore_s:.1f} s; "
        f"restored state bitwise {same_state}; steps 3-4 straight {straight}, "
        f"resumed {resumed}")
    if not same_state or straight != resumed:
        raise AssertionError("phase 8 (c): the resumed run is not bitwise the "
                             "uninterrupted one")
    return out


GRAPH_STEPS = 4    # (d): graphed steps against eager ones


def train_graph_bitwise(torch, models, cfg, data) -> dict:
    """(d) Full width at CKPT_LAYERS of the config's layers: GRAPH_STEPS
    steps of the graphed step (``make_train_step``: its warm-up, its
    capture, then replays) against GRAPH_STEPS of the functional eager
    step (``TrainStep._eager``) from the same init and batches: every
    step's metrics, and the params, moments and step after, bit for bit;
    the static leaves at their addresses."""
    from repro_torch.launch import train as launch
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import TrainConfig, make_train_step
    cut = dataclasses.replace(cfg, num_layers=CKPT_LAYERS)
    model = models.build(cut, device=DEVICE)
    step = make_train_step(model, TrainConfig(optim=opt.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=GRAPH_STEPS)))
    batches = [launch.device_batch(data.batch_at(i), DEVICE)
               for i in range(GRAPH_STEPS)]
    p = model.init(0)
    s = opt.init_state(p)
    ptrs = [t.data_ptr() for t in opt.tree_leaves((p, s))]
    ep = model.init(0)
    es = opt.init_state(ep)
    metrics_equal, losses = [], []
    for b in batches:
        p, s, m = step(p, s, b)
        ep, es, em = step._eager(ep, es, b)
        metrics_equal.append(all(torch.equal(m[k], em[k]) for k in m))
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    state_equal = all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(opt.tree_leaves((p, s)), opt.tree_leaves((ep, es))))
    same_ptrs = [t.data_ptr() for t in opt.tree_leaves((p, s))] == ptrs
    g = step.graph
    out = dict(layers=CKPT_LAYERS, steps=GRAPH_STEPS, losses=losses,
               metrics_bitwise=metrics_equal, state_bitwise=state_equal,
               static_addresses_kept=same_ptrs, replays=g.replays,
               warmup_ms=g.warmup_ms, capture_ms=g.capture_ms,
               capture_reserved_bytes=g.capture_reserved_bytes,
               static_bytes=g.static_bytes)
    log(f"  (d) graphed step at {CKPT_LAYERS} of {cfg.num_layers} layers, "
        f"{GRAPH_STEPS} steps against the eager step: metrics bitwise "
        f"{metrics_equal}, params / moments / step bitwise {state_equal}, "
        f"static addresses kept {same_ptrs}; {g.replays} replays, capture "
        f"{g.capture_ms:.1f} ms, pool {g.capture_reserved_bytes / 1e9:.3f} GB, "
        f"static tree {g.static_bytes / 1e9:.3f} GB; losses {losses}")
    if not (all(metrics_equal) and state_equal and same_ptrs
            and g.replays == GRAPH_STEPS - 1):
        raise AssertionError("phase 8 (d): the graphed steps are not bitwise "
                             "the eager steps")
    return out


TRAIN_TIMED = 3     # timed steps after the warm ones


def train_step_times(torch, launch, models, opt, loop, cfg, batch, label,
                     graphed) -> dict:
    """One train step's times on a fresh model and state: the launcher's
    step (``make_train_step``: captured, ``graphed``) or its functional
    eager step (``TrainStep._eager``). Two calls first (the graph's
    warm-up and capture; two eager steps), then one more warm call and
    TRAIN_TIMED steps by CUDA events and by the host clock (synchronised
    at the end), peak memory allocated from the first call on and memory
    reserved after, and torch.profiler over one more step: device busy ms,
    its share of the step, K1's and K5's device ms; for the graph, the
    port's kernel records of that replay held to its credit
    (``replay_launch_check``)."""
    model = models.build(cfg, device=DEVICE)
    step = loop.make_train_step(model, loop.TrainConfig(optim=opt.AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)))
    run = step if graphed else step._eager
    state = {"p": model.init(0)}
    state["s"] = opt.init_state(state["p"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def one(i):
        state["p"], state["s"], _ = run(state["p"], state["s"], batch)
    t0 = time.perf_counter()
    one(0)
    one(1)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ms_events = time_ms(one, TRAIN_TIMED)   # one more warm call inside
    host_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_TIMED + 1)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    counts = {}
    dev, kept, wall = profile_kernels(torch, one, 1, counts)
    busy = sum(dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    # K1's wgmma body and K5's bodies by their kernel names (no other
    # wgmma_packed launches in a train step: K6 and K7 run 0 times)
    k1_ms = sum(v for k, v in dev.items() if "wgmma_packed" in k) / 1e3
    k5_ms = sum(v for k, v in dev.items() if "k5_" in k) / 1e3
    out = dict(step_ms_events=ms_events, step_ms_host=host_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms_events / 1e3),
               busy_ms=busy, busy_share=busy / ms_events,
               k1_device_ms=k1_ms, k5_device_ms=k5_ms,
               first_two_calls_ms=first_ms,
               top_kernels_ms={k[:80]: v / 1e3 for k, v in top},
               profiled_wall_ms=wall, records_kept=kept,
               peak_memory_gb=peak / 1e9, state_gb=base / 1e9,
               reserved_gb=reserved / 1e9)
    if graphed:
        g = step.graph
        out.update(capture_ms=g.capture_ms, warmup_ms=g.warmup_ms,
                   pool_gb=g.capture_reserved_bytes / 1e9,
                   static_gb=g.static_bytes / 1e9, replays=g.replays,
                   replay_records=replay_launch_check(
                       lambda: kernel_counts(torch, one, 1), g.credit, 1,
                       f"phase 8, {label}'s replay", counts))
    log(f"  {label}: step {ms_events:.1f} ms (events), {host_ms:.1f} ms "
        f"(host clock); {out['tokens_per_s']:.0f} tokens/s; device busy "
        f"{busy:.1f} ms ({100 * busy / ms_events:.1f}%, records kept {kept}); "
        f"peak {peak / 1e9:.2f} GB allocated (params and state "
        f"{base / 1e9:.2f}), {reserved / 1e9:.2f} GB reserved; device ms K1 "
        f"{k1_ms:.2f}, K5 {k5_ms:.2f}; first two calls {first_ms:.1f} ms"
        + (f"; capture {out['capture_ms']:.1f} ms, pool {out['pool_gb']:.2f} "
           f"GB" if graphed else ""))
    del step, run, state, model, one
    torch.cuda.empty_cache()
    return out


def train_times_main() -> int:
    """Phase 8's times, in a process of their own (as phase 7's: late in
    the smoke's process torch.profiler loses its records): full-width
    olmo-1b on the launcher's first batch, the eager step, then the
    captured step (``train_step_times``), then the captured step with
    every dense contraction on ``torch_matmul`` (named through
    REPRO_TORCH_GEMM_STRATEGY at its warm-up and capture): the library's
    step beside K5 + K1's. Prints one line, TRAIN_TIMES_TAG + a JSON
    object."""
    import torch
    from repro_torch import models
    from repro_torch.data.pipeline import DataConfig, MarkovLM
    from repro_torch.launch import train as launch
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = launch.preset_config(TRAIN_ARCH, "full")
    data = MarkovLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH))
    batch = launch.device_batch(data.batch_at(0), DEVICE)
    args = (torch, launch, models, opt, loop, cfg, batch)
    out = dict(eager=train_step_times(*args, "eager step", graphed=False),
               graph=train_step_times(*args, "graphed step", graphed=True))
    with env_set("REPRO_TORCH_GEMM_STRATEGY", "torch_matmul"):
        out["torch_matmul_graph"] = train_step_times(
            *args, "graphed step, every product on torch_matmul", graphed=True)
    out.update(train_step_bounds(cfg, TRAIN_BATCH * TRAIN_SEQ))
    g, e = out["graph"], out["eager"]
    log(f"  graph against eager: {g['step_ms_events']:.1f} against "
        f"{e['step_ms_events']:.1f} ms a step ({e['step_ms_events'] / g['step_ms_events']:.3f}x), "
        f"{g['tokens_per_s']:.0f} against {e['tokens_per_s']:.0f} tokens/s, "
        f"busy {100 * g['busy_share']:.1f}% against {100 * e['busy_share']:.1f}%, "
        f"peak {g['peak_memory_gb']:.2f} against {e['peak_memory_gb']:.2f} GB; "
        f"GEMM bound {out['gemm_bound_ms']:.2f} ms, pack bound "
        f"{out['pack_bound_ms']:.2f} ms")
    from repro_torch.core import health
    assert_healthy(health, "phase 8's timing process")
    log(TRAIN_TIMES_TAG + json.dumps(out))
    return 0


def phase_train(torch, counters, models, card) -> tuple:
    """Phase 8: (a) ``launch.train.main`` at full width on the captured
    step (loss falls, launches by body as derived: the warm-up's counted,
    the replays' credited; its credit equal to the kernel records of the
    timing process's replay),
    each step product at its shape against torch.matmul
    (``train_shape_checks``), (b) the gradient gate, (c) the checkpoint
    round trip, (d) graphed steps bitwise eager ones, then the step's
    times, eager and graphed, in a fresh process. Returns (launches of
    (a), results)."""
    import tempfile
    from repro_torch.data.pipeline import DataConfig, MarkovLM
    from repro_torch.launch import train as launch
    t_phase = time.perf_counter()
    cfg = launch.preset_config(TRAIN_ARCH, "full")
    res = {"args": " ".join(TRAIN_ARGS)}
    fd, metrics_path = tempfile.mkstemp(prefix="phase8_", suffix=".json")
    os.close(fd)
    # The launcher's step, kept to hold a replay of its graph to the
    # kernel records.
    made, make_step = [], launch.make_train_step

    def keep_step(*args, **kw):
        made.append(make_step(*args, **kw))
        return made[-1]
    launch.make_train_step = keep_step
    try:
        counters.reset()
        t0 = time.perf_counter()
        rc = launch.main(TRAIN_ARGS + ["--metrics-out", metrics_path])
        torch.cuda.synchronize()
        res["main_s"] = time.perf_counter() - t0
        launched = counters.read()
        by_body = train_launches(counters)
        with open(metrics_path) as f:
            history = json.load(f)
    finally:
        launch.make_train_step = make_step
        os.remove(metrics_path)
    (step,) = made
    graph = step.graph
    res["graph"] = dict(replays=graph.replays, warmup_ms=graph.warmup_ms,
                        capture_ms=graph.capture_ms,
                        capture_reserved_bytes=graph.capture_reserved_bytes,
                        static_bytes=graph.static_bytes,
                        credit_by_class=credit_by_class(graph.credit))
    log(f"  (a) the launcher's step: a captured graph, {graph.replays} "
        f"replays of {TRAIN_STEPS} steps (the first its warm-up, the second "
        f"its capture); warm-up {graph.warmup_ms:.1f} ms, capture "
        f"{graph.capture_ms:.1f} ms, pool "
        f"{graph.capture_reserved_bytes / 1e9:.2f} GB, static tree "
        f"{graph.static_bytes / 1e9:.2f} GB")
    if graph.graph is None or graph.replays != TRAIN_STEPS - 1:
        raise AssertionError(f"phase 8 (a): the launcher's step replayed "
                             f"{graph.replays} times, want {TRAIN_STEPS - 1}")
    # A replay of the same graph is profiled in the timing process (late in
    # this process torch.profiler loses records: run 3 read 450 of 451 K1
    # records three times), and its records held to this graph's credit.
    del step, graph, made
    torch.cuda.empty_cache()
    losses = [h["loss"] for h in history]
    res.update(rc=rc, losses=losses, launches_by_body=by_body,
               history=history)
    want = {k: {b: c * TRAIN_STEPS for b, c in v.items()}
            for k, v in train_step_counts(cfg, TRAIN_BATCH * TRAIN_SEQ).items()}
    log(f"  (a) launch.train.main {' '.join(TRAIN_ARGS)}: rc {rc}, "
        f"{res['main_s']:.1f} s; losses {[round(x, 4) for x in losses]}; "
        f"launches {by_body} (derived {want})")
    if (rc != 0 or len(losses) != TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise AssertionError(f"phase 8 (a): losses {losses} (rc {rc})")
    if {k: by_body[k] for k in TRAIN_KERNELS} != want or by_body["others"]:
        raise AssertionError(f"phase 8 (a): launched {by_body}, derived {want}")
    shape_fails, res["shape_checks"] = train_shape_checks(
        torch, counters, cfg, TRAIN_BATCH * TRAIN_SEQ)
    if shape_fails:
        raise AssertionError(f"phase 8: the kernels missed at the step's "
                             f"shapes: {shape_fails}")
    data = MarkovLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH))
    batch = launch.device_batch(data.batch_at(0), DEVICE)
    res["grad_gate"] = train_grad_gate(torch, counters, models, cfg, batch)
    torch.cuda.empty_cache()
    res["checkpoint"] = train_ckpt_round_trip(torch, models, cfg, data)
    torch.cuda.empty_cache()
    res["graph_bitwise"] = train_graph_bitwise(torch, models, cfg, data)
    torch.cuda.empty_cache()
    log("  times, in a fresh process:")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.train_times_main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    for line in lines:
        if not line.startswith(TRAIN_TIMES_TAG):
            log(line)
    times = [ln for ln in lines if ln.startswith(TRAIN_TIMES_TAG)]
    if run.returncode != 0 or len(times) != 1:
        log(run.stderr[-4000:])
        raise AssertionError(f"phase 8's timing process failed (exit "
                             f"{run.returncode})")
    res["times"] = json.loads(times[0][len(TRAIN_TIMES_TAG):])
    res["times"]["process_s"] = time.perf_counter() - t0
    replayed = res["times"]["graph"]["replay_records"]
    log(f"  (a) the launcher's graph credits {res['graph']['credit_by_class']} "
        f"a replay; a replay of the same step's graph in the timing process "
        f"launched {replayed}")
    if replayed != res["graph"]["credit_by_class"]:
        raise AssertionError("phase 8 (a): the launcher's graph credits other "
                             "launches than a replay of its step launched")
    res["phase_s"] = time.perf_counter() - t_phase
    res["card"] = card
    log(json.dumps({"train": {k: v for k, v in res.items() if k != "history"}}))
    log(f"  phase 8 took {res['phase_s']:.1f} s")
    return launched, res


# Phase 10: the multi-device layer on the card, in a process of its own
# (NCCL is never initialised in the smoke's process). (a) The
# sequence-parallel decode collective under a one-rank NCCL group at
# olmo-1b's decode width (B 4, H = Hkv = 16, D 128, S 2048), f32 and bf16,
# with a window and with invalid slots, each against its plain oracle; (b)
# the train launcher at phase 8's widths for PARALLEL_STEPS steps with no
# group, then again under the one-rank group with --model-parallel 1: the
# losses bitwise, the K1 / K5 launches by body as phase 8 derives them, the
# step a captured graph in both.
PARALLEL_TAG = "phase 10: "
PARALLEL_STEPS = 3
SP_DECODE = dict(b=4, h=16, hkv=16, d=128, s=2048)
SP_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
SP_CASES = ((None, 0), (1024, 300))       # (window, invalid slots)


def sp_decode_checks(torch, coll, mesh) -> list:
    """(a): ``sp_decode_attention`` against ``ref_decode_attention`` on the
    same card tensors, and the ms of each (CUDA events, 20 calls)."""
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    b, h, hkv, d, s = (SP_DECODE[k] for k in ("b", "h", "hkv", "d", "s"))
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for window, invalid in SP_CASES:
            q = torch.randn((b, h, d), generator=gen, device=DEVICE).to(dt)
            k = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE).to(dt)
            v = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE).to(dt)
            kpos = torch.arange(s, device=DEVICE)[None].repeat(b, 1)
            kpos[:, :invalid] = -1
            qpos = torch.full((b,), s - 1, device=DEVICE)
            args = (q, k, v, kpos, qpos)
            got = coll.sp_decode_attention(*args, mesh=mesh, window=window)
            want = coll.ref_decode_attention(*args, window=window)
            err = float((got.float() - want.float()).abs().max())
            rows.append(dict(
                dtype=str(dt), window=window, invalid=invalid,
                max_abs_err=err, tol=SP_TOL[str(dt)],
                ok=err <= SP_TOL[str(dt)] and got.dtype == dt
                and got.shape == want.shape,
                ms=time_ms(lambda i: coll.sp_decode_attention(
                    *args, mesh=mesh, window=window), 20),
                plain_ms=time_ms(lambda i: coll.ref_decode_attention(
                    *args, window=window), 20)))
            log(f"  (a) sp_decode_attention {dt} window {window} invalid "
                f"{invalid}: max|err| {err:.2e} (tol {SP_TOL[str(dt)]}), "
                f"{rows[-1]['ms']:.4f} ms against the oracle's "
                f"{rows[-1]['plain_ms']:.4f}")
    return rows


def parallel_train_run(torch, counters, launch, label) -> dict:
    """(b): one run of ``launch.train.main`` at phase 8's widths, its
    losses, launches by body and whether its step was a captured graph."""
    import tempfile
    fd, path = tempfile.mkstemp(prefix="phase10_", suffix=".json")
    os.close(fd)
    made, make_step = [], launch.make_train_step

    def keep_step(*args, **kw):
        made.append(make_step(*args, **kw))
        return made[-1]
    launch.make_train_step = keep_step
    try:
        counters.reset()
        t0 = time.perf_counter()
        rc = launch.main(TRAIN_ARGS[:-4] + [
            "--steps", str(PARALLEL_STEPS), "--log-every", "1",
            "--model-parallel", "1", "--metrics-out", path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        with open(path) as f:
            losses = [h["loss"] for h in json.load(f)]
    finally:
        launch.make_train_step = make_step
        os.remove(path)
    (step,) = made
    graph = step.graph
    out = dict(rc=rc, losses=losses, launches_by_body=train_launches(counters),
               captured=graph.graph is not None,
               replays=graph.replays, s=seconds)
    log(f"  (b) {label}: rc {rc}, {seconds:.1f} s, losses {losses}, "
        f"launches {out['launches_by_body']}, a captured graph "
        f"{out['captured']} ({graph.replays} replays)")
    del step, graph, made
    torch.cuda.empty_cache()
    return out


def parallel_main() -> int:
    """Phase 10's process: (b) with no group, then the group joined as
    ``launch.train`` joins it (``WORLD_SIZE`` 1, NCCL), (b) again and (a).
    Prints one line, PARALLEL_TAG + a JSON object."""
    import socket
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import health
    from repro_torch.kernels import counted_wrappers
    from repro_torch.launch import train as launch
    from repro_torch.parallel import collectives as coll
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = Counters(counted_wrappers())
    cfg = launch.preset_config(TRAIN_ARCH, "full")
    want = {k: {b: c * PARALLEL_STEPS for b, c in v.items()}
            for k, v in train_step_counts(cfg, TRAIN_BATCH * TRAIN_SEQ).items()}
    out = {"want_launches_by_body": want}
    out["no_group"] = parallel_train_run(torch, counters, launch, "no group")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    out["nccl_group"] = parallel_train_run(torch, counters, launch,
                                           "a one-rank NCCL group")
    if not (dist.is_initialized() and dist.get_backend() == "nccl"
            and dist.get_world_size() == 1):
        raise AssertionError("phase 10: the launcher did not join a "
                             "one-rank NCCL group")
    mesh = DeviceMesh(torch.device(DEVICE).type, torch.arange(1),
                      mesh_dim_names=("model",))
    out["sp_decode"] = sp_decode_checks(torch, coll, mesh)
    del mesh   # the mesh holds the group: let it end inside destroy
    dist.destroy_process_group()
    assert_healthy(health, "phase 10's process")
    log(PARALLEL_TAG + json.dumps(out))
    return 0


def phase_parallel(card) -> dict:
    """Phase 10 (see PARALLEL_TAG's comment), run in a fresh process;
    fails unless every check holds."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.parallel_main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    for line in lines:
        if not line.startswith(PARALLEL_TAG):
            log(line)
    tagged = [ln for ln in lines if ln.startswith(PARALLEL_TAG)]
    if run.returncode != 0 or len(tagged) != 1:
        log(run.stderr[-4000:])
        raise AssertionError(f"phase 10's process failed (exit "
                             f"{run.returncode})")
    res = json.loads(tagged[0][len(PARALLEL_TAG):])
    want = res["want_launches_by_body"]
    fails = [r for r in res["sp_decode"] if not r["ok"]]
    for label in ("no_group", "nccl_group"):
        r = res[label]
        got = {k: r["launches_by_body"][k] for k in TRAIN_KERNELS}
        if r["rc"] != 0 or not r["captured"] or got != want \
                or r["launches_by_body"]["others"] \
                or len(r["losses"]) != PARALLEL_STEPS:
            fails.append((label, r["rc"], r["captured"], got, want))
    if res["no_group"]["losses"] != res["nccl_group"]["losses"]:
        fails.append(("losses not bitwise", res["no_group"]["losses"],
                      res["nccl_group"]["losses"]))
    res["phase_s"] = time.perf_counter() - t0
    res["card"] = card
    log(json.dumps({"parallel": res}))
    log(f"  phase 10 took {res['phase_s']:.1f} s")
    if fails:
        raise AssertionError(f"phase 10: {fails}")
    return res


# Phase 11: the other five families' training at published widths, as jobs
# of the port's harness (``repro_torch.harness.run_plan`` on ``local-cuda``),
# in a process of its own. Each family trains HARNESS_STEPS steps of
# ``train.loop.make_train_step`` (the warm-up, the capture and its replay,
# two more replays): bf16 compute over f32 masters, remat, Markov tokens
# from a seed, N(0, 1) bf16 patch embeddings (paligemma) and frames
# (whisper) as phase 7 feeds them. The plan also holds a job with
# ``harness_job`` injected at its first attempt, a job that asks for twice
# the card's memory (it must fail as ``resource`` after its retries, and
# the training job after it complete) and an ``h100-pod`` job routed to the
# manifest executor.
HARNESS_TAG = "phase 11: "
HARNESS_ARCHS = ("qwen3-4b", "mamba2-130m", "hymba-1.5b", "paligemma-3b",
                 "whisper-base")
HARNESS_BATCH, HARNESS_SEQ, HARNESS_STEPS = 2, 512, 4
# Layers trained out of the config's, and why: depth is cut only where one
# card's 80 GB forces it, to a depth whose peak leaves room for the smoke's
# own process beside this one. f32 masters, both Adam moments and the
# gradients are 16 bytes a parameter; the captured step's pool holds the
# bf16 copies, packs and activations besides. Peaks allocated at 2 x 512
# tokens a step, measured on an H100 80GB (tools/train_depth_peaks.py):
# qwen3-4b 42.8 GB at 4 layers, 57.4 at 8, 64.1 at 12; paligemma-3b 35.1
# at 4, 51.0 at 8, 58.9 at 10, 59.4 at 12; hymba-1.5b 53.3 at all 32.
HARNESS_DEPTH = {
    "qwen3-4b": (12, "state and graph pool grow 3.3 GB a layer from a 64.1 "
                     "GB peak at 12 layers: all 36 would need about 143 GB"),
    "mamba2-130m": (None, ""),
    "hymba-1.5b": (None, ""),
    "paligemma-3b": (12, "state and graph pool grow 3.4 GB a layer from a "
                         "59.4 GB peak at 12 layers: all 18 would need about "
                         "80 GB, the whole card"),
    "whisper-base": (None, ""),
}
HARNESS_SEED = 40            # config i's patches / frames: HARNESS_SEED + i
HARNESS_JOB_TIMEOUT_S = 600.0


def harness_batches(torch, cfg, seed) -> list:
    """HARNESS_STEPS Markov batches of HARNESS_BATCH x HARNESS_SEQ tokens on
    the card, with N(0, 1) bf16 ``patches`` / ``frames`` where the family
    takes them (drawn from ``seed``, as ``family_batch`` draws phase 7's)."""
    from repro_torch.data.pipeline import DataConfig, MarkovLM
    from repro_torch.launch.train import device_batch
    data = MarkovLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=HARNESS_SEQ,
                               global_batch=HARNESS_BATCH))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for i in range(HARNESS_STEPS):
        batch = device_batch(data.batch_at(i), DEVICE)
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (HARNESS_BATCH, cfg.num_patches, cfg.d_model),
                generator=gen).to(torch.bfloat16).to(DEVICE)
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn(
                (HARNESS_BATCH, cfg.encoder_seq, cfg.d_model),
                generator=gen).to(torch.bfloat16).to(DEVICE)
        out.append(batch)
    return out


@contextlib.contextmanager
def k1_products(seen):
    """Within the block, every call of the ``tiling_packing_fused`` lowering
    (K5 packs B, then K1) is recorded in ``seen``: {(M, K, N, A's strides,
    B's strides): calls}."""
    from repro_torch.core import strategy
    run = strategy._DENSE["tiling_packing_fused"]

    def record(a, b, *args, **kw):
        key = (a.shape[0], a.shape[1], b.shape[1], tuple(a.stride()),
               tuple(b.stride()))
        seen[key] = seen.get(key, 0) + 1
        return run(a, b, *args, **kw)
    strategy._DENSE["tiling_packing_fused"] = record
    try:
        yield
    finally:
        strategy._DENSE["tiling_packing_fused"] = run


def strided_operand(torch, gen, rows, cols, stride, std):
    """N(0, std^2) bf16 [rows, cols] laid out with ``stride``: as it lies
    (unit column stride, row stride >= cols) or a transposed view (unit row
    stride), over a buffer as wide as the stride."""
    if stride[1] == 1:
        buf = torch.randn((rows, stride[0]), generator=gen, device=DEVICE)
        return (buf * std).to(torch.bfloat16)[:, :cols]
    buf = torch.randn((cols, stride[1]), generator=gen, device=DEVICE)
    return (buf * std).to(torch.bfloat16)[:, :rows].t()


def k1_product_checks(torch, counters, products, seed=8) -> tuple:
    """Each distinct K1 product a step launched (``k1_products``), again
    alone at its shape and strides through ``gemm.matmul`` on the same
    lowering, against torch.matmul in f32 (TF32 off) on the same bf16
    inputs rounded to bf16, at phase 1's tolerances (2e-2 / 1e-3; A N(0, 1),
    B N(0, 1 / K), as ``train_shape_checks``): one K5 and one K1 launch,
    nothing else. Returns (failed tags, one row a product)."""
    from repro_torch.core import gemm
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    fails, rows = [], []
    for (m, k, n, a_stride, b_stride), calls in sorted(products.items()):
        a = strided_operand(torch, gen, m, k, a_stride, 1.0)
        b = strided_operand(torch, gen, k, n, b_stride, k ** -0.5)
        counters.reset()
        got = gemm.matmul(a, b, strategy="tiling_packing_fused")
        torch.cuda.synchronize()
        ran = train_launches(counters)
        launched = {kern: sum(ran[kern].values()) for kern in TRAIN_KERNELS}
        want = (a.float() @ b.float()).to(torch.bfloat16)
        ok, err = close(got, want, 2e-2, 1e-3)
        view = "B^T view" if b_stride[0] == 1 else "B as it lies"
        tag = f"M={m} K={k} N={n} ({view}, {calls} a step)"
        ok = ok and ran["others"] == 0 and launched == {
            "gemm_packed_fused_a": 1, "pack_b": 1, "gemm_tiled": 0}
        rows.append(dict(m=m, k=k, n=n, a_stride=a_stride, b_stride=b_stride,
                         calls=calls, bodies={kern: ran[kern] for kern in
                                              ("gemm_packed_fused_a", "pack_b")},
                         max_abs_err=err, ok=ok))
        if not ok:
            fails.append(tag)
            log(f"    check {tag} [{ran}]: max_abs_err={err:.3e} (rtol=2e-2, "
                f"atol=1e-3) FAIL")
        del a, b, got, want
    torch.cuda.empty_cache()
    log(f"    K1 products at their shapes: {len(rows) - len(fails)} of "
        f"{len(rows)} held to torch.matmul (2e-2 / 1e-3), one K5 + one K1 "
        f"each; largest error "
        f"{max((r['max_abs_err'] for r in rows), default=0.0):.3e}")
    return fails, rows


def train_family(torch, counters, arch, card, depth=None) -> dict:
    """One family's training job (see HARNESS_TAG's comment): HARNESS_STEPS
    steps of the captured step (the warm-up, counted and its K1 products
    recorded; the capture; a replay timed by CUDA events; a replay profiled
    and its kernel records held to the graph's credit), then the checks:
    every loss finite, launches only on TRAIN_KERNELS (for a dense config
    equal to ``train_step_counts``, its products held at shape by
    ``train_shape_checks``; else each K1 product by ``k1_product_checks``).
    Raises on a failed check. Returns the results."""
    import gc

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import TrainConfig, make_train_step
    t0 = time.perf_counter()
    full = get_config(arch)
    layers, why = HARNESS_DEPTH[arch]
    layers = depth or layers or full.num_layers
    cfg = dataclasses.replace(full, num_layers=layers)
    tokens = HARNESS_BATCH * HARNESS_SEQ
    if cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{arch}: compute {cfg.compute_dtype}, not bf16")
    cut = (f"{layers} of {full.num_layers} layers ({why})"
           if layers < full.num_layers else f"all {layers} layers")
    log(f"  {arch}: published widths (d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}), {cut}; {cfg.num_params() / 1e9:.3f} B parameters "
        f"trained; {HARNESS_BATCH} x {HARNESS_SEQ} tokens a step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = models.build(cfg, device=DEVICE)
    step = make_train_step(model, TrainConfig(optim=opt.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=HARNESS_STEPS)))
    batches = harness_batches(torch, cfg, HARNESS_SEED
                              + HARNESS_ARCHS.index(arch))
    state = {"p": model.init(0)}
    state["s"] = opt.init_state(state["p"])
    torch.cuda.synchronize()
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    metrics, ms = [], []

    def one(i):
        state["p"], state["s"], m = step(state["p"], state["s"], batches[i])
        metrics.append(m["loss"].clone())

    def timed(i):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        one(i)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    products = {}
    counters.reset()
    with k1_products(products):
        timed(0)                     # the warm-up: eager, counted
    warm_k1 = counters.read()["gemm_packed_fused_a"]
    timed(1)                         # the capture
    timed(2)                         # a replay
    counts = {}
    profile_kernels(torch, lambda i: one(3), 1, counts, warm=False)
    torch.cuda.synchronize()
    launched = counters.read()
    by_body = train_launches(counters)
    graph = step.graph
    losses = [float(x) for x in metrics]
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    step_ms = ms[2]
    res = dict(arch=arch, layers=layers, published_layers=full.num_layers,
               depth_cut=why if layers < full.num_layers else None,
               params_b=cfg.num_params() / 1e9, tokens_per_step=tokens,
               losses=losses, warmup_ms=ms[0], capture_call_ms=ms[1],
               step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               peak_gb=peak_gb, state_gb=state_gb, launches=launched,
               launches_by_body=by_body, replays=graph.replays,
               capture_ms=graph.capture_ms,
               pool_gb=graph.capture_reserved_bytes / 1e9, card=card)
    log(f"    losses {[round(x, 4) for x in losses]}; step {step_ms:.1f} ms "
        f"(CUDA events, a replay), {res['tokens_per_s']:.0f} tokens/s; peak "
        f"{peak_gb:.2f} GB allocated (params and state {state_gb:.2f}); "
        f"warm-up {ms[0]:.1f} ms, capture call {ms[1]:.1f} ms (capture "
        f"{graph.capture_ms:.1f} ms, pool {res['pool_gb']:.2f} GB); card "
        f"{card}")
    log(f"    launches of {HARNESS_STEPS} steps by body: {by_body}")
    fails = []
    if len(losses) != HARNESS_STEPS or not all(math.isfinite(x)
                                               for x in losses):
        fails.append(f"losses {losses}")
    if graph.graph is None or graph.replays != HARNESS_STEPS - 1:
        fails.append(f"{graph.replays} replays")
    if by_body["others"]:
        fails.append(f"other kernels launched: {launched}")
    if sum(products.values()) != warm_k1:
        fails.append(f"the warm-up launched K1 {warm_k1} times, its "
                     f"products {sum(products.values())}")
    try:
        res["replay_records"] = replay_launch_check(
            lambda: kernel_counts(torch, lambda i: one(3), 1), graph.credit,
            1, f"phase 11, {arch}'s replay", counts)
    except AssertionError as exc:
        fails.append(str(exc))
    del step, graph, model, state, batches, one, timed
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family == "dense":
        want = {kern: {b: c * HARNESS_STEPS for b, c in v.items()}
                for kern, v in train_step_counts(cfg, tokens).items()}
        res["derived_launches"] = want
        if {kern: by_body[kern] for kern in TRAIN_KERNELS} != want:
            fails.append(f"launched {by_body}, derived {want}")
        shape_fails, res["shape_checks"] = train_shape_checks(
            torch, counters, cfg, tokens)
    else:
        shape_fails, res["shape_checks"] = k1_product_checks(
            torch, counters, products)
    fails += [f"product {t}" for t in shape_fails]
    res["job_s"] = time.perf_counter() - t0
    log(f"    {arch}: {len(res['shape_checks'])} distinct products checked; "
        f"job {res['job_s']:.1f} s")
    if fails:
        raise AssertionError(f"{arch}: " + "; ".join(fails))
    return res


def harness_plan(torch, counters, card, results) -> list:
    """The phase's RunSpecs: the probe (``harness_job`` injected at its
    first attempt), qwen3-4b, mamba2-130m, hymba-1.5b, the job that asks
    for twice the card's memory, paligemma-3b, whisper-base, and qwen3-4b
    on ``h100-pod`` (a manifest)."""
    from repro_torch.core import gemm
    from repro_torch.harness import TOPOLOGIES, RunSpec

    def probe(device):
        gen = torch.Generator(device=device).manual_seed(3)
        a = torch.randn((512, 2048), generator=gen, device=device)
        b = torch.randn((2048, 2048), generator=gen, device=device) / 45.0
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ok, err = close(gemm.matmul(a, b), (a.float() @ b.float()).to(
            torch.bfloat16), 2e-2, 1e-3)
        results["probe"] = dict(max_abs_err=err, ok=ok)
        if not ok:
            raise AssertionError(f"probe: max_abs_err {err:.3e}")

    def greedy(device):
        total = torch.cuda.get_device_properties(0).total_memory
        results.setdefault("greedy_attempts", 0)
        results["greedy_attempts"] += 1
        try:
            torch.empty(2 * total, dtype=torch.uint8, device=device)
        finally:
            torch.cuda.empty_cache()

    def train(config, device):
        if device != DEVICE:
            raise AssertionError(f"{config}: device {device!r}")
        results[config] = train_family(torch, counters, config, card)

    def never():
        raise AssertionError("a manifest job ran")

    t = dict(timeout_s=HARNESS_JOB_TIMEOUT_S, max_retries=0)
    archs = dict(enumerate(HARNESS_ARCHS, start=1))
    return [RunSpec(bench="probe", fn=probe, order=0, max_retries=1),
            *[RunSpec(bench="train", fn=train, configs=(arch,), order=i, **t)
              for i, arch in archs.items() if i <= 3],
            RunSpec(bench="greedy", fn=greedy, order=4, max_retries=2),
            *[RunSpec(bench="train", fn=train, configs=(arch,), order=i + 1,
                      **t) for i, arch in archs.items() if i > 3],
            RunSpec(bench="train", fn=never, configs=("qwen3-4b",), order=8,
                    topologies=(TOPOLOGIES["h100-pod"],))]


# What the plan must report: the probe, five trainings completed (the
# probe after one retry), the greedy job failed after its two, one
# manifest.
HARNESS_COUNTERS = {"jobs": 8, "completed": 6, "failed": 1, "emitted": 1,
                    "retries": 3, "regression_failures": 0}


def harness_report_checks(report) -> list:
    """The phase's verdicts on ``harness_report.json``: the counters, the
    exit code (1: the planted failure's), an empty health snapshot, each
    row's status and class, the manifest's resources. Returns failures."""
    fails = []
    if report["counters"] != HARNESS_COUNTERS:
        fails.append(f"counters {report['counters']}, want {HARNESS_COUNTERS}")
    if report["exit_code"] != 1 or report["health"]:
        fails.append(f"exit_code {report['exit_code']}, health "
                     f"{report['health']}")
    rows = {j["name"]: j for j in report["jobs"]}
    want = {"probe": ("completed", 2, None),
            "greedy": ("failed", 3, "resource"),
            "train--qwen3-4b--h100-pod": ("emitted", 0, None),
            **{f"train--{arch}": ("completed", 1, None)
               for arch in HARNESS_ARCHS}}
    got = {n: (r["status"], r["attempts"], r["failure_class"])
           for n, r in rows.items()}
    if got != want:
        fails.append(f"jobs {got}, want {want}")
    pod = rows.get("train--qwen3-4b--h100-pod")
    if pod is not None:
        with open(pod["manifest"]) as f:
            man = json.load(f)
        limits = man["spec"]["template"]["spec"]["containers"][0][
            "resources"]["limits"]
        if limits != {"nvidia.com/gpu": 8} or man["spec"]["parallelism"] != 32:
            fails.append(f"manifest limits {limits}, parallelism "
                         f"{man['spec']['parallelism']}")
    return fails


def harness_main() -> int:
    """Phase 11's process: the plan (``harness_plan``) through
    ``repro_torch.harness.run_plan`` on ``local-cuda`` with ``harness_job``
    armed at its first hit (the probe's first attempt), its report read back
    from ``results/harness/<run-id>/harness_report.json`` and checked
    (``harness_report_checks``). Prints one line, HARNESS_TAG + a JSON
    object."""
    import torch
    from repro_torch.core import health
    from repro_torch.harness import expand, run_plan
    from repro_torch.kernels import counted_wrappers
    from repro_torch.testing import faults
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    card = card_line()
    free, total = torch.cuda.mem_get_info()
    log(f"  card {card}: {free / 1e9:.1f} of {total / 1e9:.1f} GB free at the "
        f"phase's start")
    counters = Counters(counted_wrappers())
    results = {}
    plan = expand(harness_plan(torch, counters, card, results))
    run_id = time.strftime("smoke-phase11-%Y%m%dT%H%M%S")
    run_dir = ROOT / "results" / "harness" / run_id
    with faults.inject("harness_job", nth=1):
        run_plan(plan, root=run_dir, run_dir=run_dir, run_id=run_id)
    with open(run_dir / "harness_report.json") as f:
        on_disk = json.load(f)
    fails = harness_report_checks(on_disk)
    for row in on_disk["jobs"]:
        log(f"  job {row['name']}: {row['status']} ({row['executor']}), "
            f"attempts {row['attempts']}, retries {row['retries']}, "
            f"{row['duration_s']:.1f} s"
            + (f", {row['failure_class']}: {row['detail'][:300]}"
               if row["failure_class"] else ""))
    for fail in fails:
        log(f"  phase 11: {fail}")
    assert_healthy(health, "phase 11's process")
    out = dict(report=on_disk, report_path=str(run_dir / "harness_report.json"),
               families={a: results[a] for a in HARNESS_ARCHS if a in results},
               probe=results.get("probe"),
               greedy_attempts=results.get("greedy_attempts"),
               fails=fails, card=card, process_s=time.perf_counter() - t0)
    log(HARNESS_TAG + json.dumps(out))
    return 1 if fails else 0


def phase_harness(card) -> dict:
    """Phase 11 (see HARNESS_TAG's comment), run in a fresh process; fails
    unless its report and every job's checks hold. Returns the results."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.harness_main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    for line in lines:
        if not line.startswith(HARNESS_TAG):
            log(line)
    tagged = [ln for ln in lines if ln.startswith(HARNESS_TAG)]
    if run.returncode != 0 or len(tagged) != 1:
        log(run.stderr[-4000:])
        raise AssertionError(f"phase 11's process failed (exit "
                             f"{run.returncode})")
    res = json.loads(tagged[0][len(HARNESS_TAG):])
    missing = [a for a in HARNESS_ARCHS if a not in res["families"]]
    if missing:
        raise AssertionError(f"phase 11: no results for {missing}")
    res["phase_s"] = time.perf_counter() - t0
    res["card"] = card
    summary = {a: {k: r[k] for k in ("layers", "published_layers", "depth_cut",
                                     "step_ms", "tokens_per_s", "peak_gb",
                                     "losses", "job_s")}
               for a, r in res["families"].items()}
    log(json.dumps({"harness_training": summary, "counters":
                    res["report"]["counters"], "phase_s": res["phase_s"],
                    "card": card}))
    log(f"  phase 11 took {res['phase_s']:.1f} s")
    return res


# Phase 12: the public GEMM surface that the served and trained paths do
# not call by name, in a process of its own. (a) The grouped facades
# (``core.grouped_silu_gate`` + ``core.grouped_linear``, the MoE gate/up
# pair then the down projection) at mixtral-8x22b's expert widths in bf16
# on top-2 routing counts from a seed: packed stacks with counts (K2) and
# without (K3), raw stacks under ``grouped_packed_ragged`` (K5 + K2) and
# ``grouped_packed`` (K5 + K3). (b) ``core.LayeredGemm`` at olmo-1b's gate /
# up shape, one object per strategy, each called LAYERED_CALLS times. Then,
# from the smoke's process, the four example entry points as processes of
# their own on the card.
SURFACE_TAG = "phase 12: "
SURFACE_TOKENS = 4 * 128             # routed tokens: batch 4 x prompt 128
SURFACE_SEED = 12
SURFACE_REPS = 3
# (label, weight kind, strategy, counts) of each facade run
SURFACE_CASES = (("packed, counts", "packed", "auto", True),
                 ("packed, no counts", "packed", "auto", False),
                 ("raw, grouped_packed_ragged", "raw", "grouped_packed_ragged",
                  True),
                 ("raw, grouped_packed", "raw", "grouped_packed", False))
LAYERED_SHAPES = ((4, 2048, 8192), (512, 2048, 8192))  # olmo-1b's gate / up
LAYERED_CALLS = 3
# LayeredGemm's bf16 bodies at olmo-1b's shapes, by strategy and M, as
# phase 1 holds them for K6 / K7 / K8 and phase 4 for K1 (intrinsic: K7's
# one block on a TMA body).
LAYERED_BODIES = {
    "tiling": {4: "gemm_tiled:tc_stream", 512: "gemm_tiled:wgmma"},
    "intrinsic": {4: "gemm_tiled:tc_stream", 512: "gemm_tiled:wgmma"},
    "tiling_packing": {4: "gemm_packed:tc_stream", 512: "gemm_packed:wgmma"},
    "tiling_packing_fused": {4: "gemm_packed_fused_a:tc_stream",
                             512: "gemm_packed_fused_a:wgmma"},
    "vsx": {4: "matmul_vsx_like:fma_stream", 512: "matmul_vsx_like:fma_tiled"}}
EXAMPLE_TIMEOUT_S = 300
# name -> argv after the script; the errors each prints, as "max|err| = E
# (gate G)", must all be within their gates
EXAMPLES = {
    "torch_quickstart": [],
    "torch_serve_lm": ["--arch", "olmo-1b", "--batch", "2", "--new", "4",
                       "--pack-weights"],
    "torch_serve_lm --stream --continuous": [
        "--arch", "olmo-1b", "--batch", "12", "--new", "4", "--pack-weights",
        "--stream", "--continuous"],
    "torch_train_lm": ["--steps", "4", "--log-every", "1"],
    "torch_gemm_strategies": ["--sizes", "256,1024,4096"],
}
EXAMPLE_ERRORS = {"torch_quickstart": 12, "torch_gemm_strategies": 3}
ERR_LINE = r"max\|err\| = ([0-9.e+-]+) \(gate ([0-9.e+-]+)\)"


def surface_counts(torch, gen, experts, capacity):
    """Top-2 routing counts of SURFACE_TOKENS tokens over ``experts``
    experts from the seeded logits, expert 0's column at -inf so that it
    gets no token, each count capped at ``capacity`` as the MoE layer drops
    the tokens past it: [1, E] int32 (one routing group)."""
    logits = torch.randn((SURFACE_TOKENS, experts), generator=gen,
                         device=DEVICE)
    logits[:, 0] = float("-inf")
    top = torch.topk(logits, 2, dim=-1).indices.flatten()
    counts = torch.bincount(top, minlength=experts).clamp(max=capacity)
    return counts.to(torch.int32)[None]


def facade_bound_ms(counts, capacity, k, n, streams, packs):
    """Least time of one facade call on this run's counts: the live
    experts' stacks (``streams`` of them), the live rows of A read once,
    the whole [E, C, n] output written once, the products of the live rows
    only; with ``packs``, K5's read and write of each raw stack before it."""
    live_rows = int(counts.sum())
    live = int((counts > 0).sum())
    e = counts.numel()
    stack = k * n * 2
    nbytes = (live * stack * streams + live_rows * k * 2 + e * capacity * n * 2
              + packs * 2 * e * stack)
    flops = 2.0 * live_rows * k * n * streams
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def facade_checks(torch, counters, core, ref, cfg) -> dict:
    """Phase 12 (a): SURFACE_CASES at mixtral-8x22b's expert widths. Every
    output within 2e-2 / 1e-3 of the f32 oracle on the same inputs (the
    down projection's on the pair's own output), rows past the counts
    exactly 0, launches by kernel and body as each case must take them;
    then each call timed (CUDA events, uncounted)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    c = int(SURFACE_TOKENS * cfg.num_experts_per_tok * cfg.capacity_factor
            / e)
    c = max(8, -(-c // 8) * 8)        # the MoE layer's capacity (moe._capacity)
    gen = torch.Generator(device=DEVICE).manual_seed(SURFACE_SEED)
    counts = surface_counts(torch, gen, e, c)
    bf16 = torch.bfloat16
    x = torch.randn((1, e, c, d), generator=gen, device=DEVICE, dtype=bf16)
    wg = torch.randn((e, d, f), generator=gen, device=DEVICE, dtype=bf16) * 0.02
    wu = torch.randn((e, d, f), generator=gen, device=DEVICE, dtype=bf16) * 0.02
    wo = torch.randn((e, f, d), generator=gen, device=DEVICE, dtype=bf16) * 0.01
    counters.reset()
    pg = core.GroupedPackedWeight.pack(wg, n_b_streams=2)
    pu = core.GroupedPackedWeight.pack(wu, plan=pg.plan)
    po = core.GroupedPackedWeight.pack(wo)
    torch.cuda.synchronize()
    load = counters.read()
    load_bodies = counters.variants()["pack_b_grouped"]
    stacks = {"packed": (pg, pu, po), "raw": (wg, wu, wo)}
    live = torch.arange(c, device=DEVICE)[None, None, :] < counts[..., None]

    def run(kind, strategy, with_counts):
        g, u, o = stacks[kind]
        cnt = counts if with_counts else None
        h = core.grouped_silu_gate(x, g, u, counts=cnt, strategy=strategy)
        return h, core.grouped_linear(h, o, counts=cnt, strategy=strategy)

    # -- the counted pass ------------------------------------------------------
    counters.reset()
    outs, deltas = [], []
    for label, kind, strategy, with_counts in SURFACE_CASES:
        before_n, before_v = counters.read(), counters.variants()
        outs.append(run(kind, strategy, with_counts))
        after_n, after_v = counters.read(), counters.variants()
        deltas.append(({k: after_n[k] - before_n[k] for k in after_n
                        if after_n[k] != before_n[k]},
                       {k: {b: after_v[k][b] - before_v[k][b]
                            for b in after_v[k] if after_v[k][b] != before_v[k][b]}
                        for k in after_v if after_v[k] != before_v[k]}))
    torch.cuda.synchronize()
    launches, variants = counters.read(), counters.variants()

    # -- checks ----------------------------------------------------------------
    fails, rows = [], []
    x4 = x[0][:, None]                      # [E, S=1, C, K]
    cnt_t = counts.t().contiguous()         # [E, S=1]
    full = torch.full_like(cnt_t, c)
    want_h = {wc: ref.grouped_ragged_ref(x4, wg, cnt_t if wc else full, b2=wu,
                                         out_dtype=torch.float32)[:, 0][None]
              for wc in (True, False)}
    for (label, kind, strategy, wc), (h, y), (dn, dv) in zip(SURFACE_CASES,
                                                             outs, deltas):
        kernel = "gemm_grouped_packed_ragged" if wc else "gemm_grouped_packed"
        want_n = {kernel: 2, **({"pack_b_grouped": 3} if kind == "raw" else {})}
        want_v = {kernel: {"wgmma": 2},
                  **({"pack_b_grouped": {"tma_copy": 3}} if kind == "raw"
                     else {})}
        want_y = ref.grouped_ragged_ref(h[0][:, None], wo, cnt_t if wc else full,
                                        out_dtype=torch.float32)[:, 0][None]
        ok_h, err_h = close(h, want_h[wc], 2e-2, 1e-3)
        ok_y, err_y = close(y, want_y, 2e-2, 1e-3)
        zeros = (bool((h[~live.expand_as(h[..., 0])] == 0).all())
                 and bool((y[~live.expand_as(y[..., 0])] == 0).all())
                 if wc else None)
        row = dict(case=label, strategy=strategy, counts=wc, launches=dn,
                   launches_by_body=dv, want_launches=want_n,
                   want_launches_by_body=want_v, gate_up_err=err_h,
                   down_err=err_y, zeros_past_counts=zeros,
                   shapes=f"x [1, {e}, {c}, {d}] bf16, gate/up [{e}, {d}, {f}], "
                          f"down [{e}, {f}, {d}]")
        log(f"  {label}: gate/up err {err_h:.3e}, down err {err_y:.3e} "
            f"(rtol 2e-2, atol 1e-3), zeros past counts {zeros}, launches "
            f"{dn} by body {dv}")
        if not (ok_h and ok_y and zeros in (None, True) and dn == want_n
                and dv == want_v and h.dtype == y.dtype == bf16):
            fails.append(row)
        rows.append(row)
    del outs
    torch.cuda.empty_cache()

    # -- times (uncounted) -----------------------------------------------------
    for row, (label, kind, strategy, wc) in zip(rows, SURFACE_CASES):
        g, u, o = stacks[kind]
        cnt = counts if wc else None
        h = core.grouped_silu_gate(x, g, u, counts=cnt, strategy=strategy)
        row["gate_up_ms"] = time_ms(lambda i: core.grouped_silu_gate(
            x, g, u, counts=cnt, strategy=strategy), SURFACE_REPS)
        row["down_ms"] = time_ms(lambda i: core.grouped_linear(
            h, o, counts=cnt, strategy=strategy), SURFACE_REPS)
        live_counts = counts if wc else torch.full_like(counts, c)
        packs = 1 if kind == "raw" else 0
        row["gate_up_bound_ms"], row["gate_up_bound_by"] = facade_bound_ms(
            live_counts, c, d, f, 2, packs)
        row["down_bound_ms"], row["down_bound_by"] = facade_bound_ms(
            live_counts, c, f, d, 1, packs)
        log(f"  {label}: gate/up {row['gate_up_ms']:.3f} ms (bound "
            f"{row['gate_up_bound_ms']:.3f}, {row['gate_up_bound_by']}), down "
            f"{row['down_ms']:.3f} ms (bound {row['down_bound_ms']:.3f})")
    return dict(capacity=c, counts=counts[0].tolist(), load=load,
                load_bodies=load_bodies, launches=launches, variants=variants,
                rows=rows, fails=fails)


def layered_checks(torch, counters, core) -> dict:
    """Phase 12 (b): one ``LayeredGemm`` per strategy (and None, the
    planner's pick) at each of LAYERED_SHAPES in f32 and bf16, each called
    LAYERED_CALLS times: every output within phase 4's tolerances of the
    f32 product (1e-4 of max|C| in f32, 1e-2 in bf16), the plan the same
    object on every call, launches by kernel equal to STRATEGY_LAUNCHES
    times the calls and, in bf16, on LAYERED_BODIES; then each object's
    call timed (CUDA events, uncounted)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SURFACE_SEED + 1)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for m, k, n in LAYERED_SHAPES:
            a = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
            b = torch.randn((k, n), generator=gen, device=DEVICE).to(dt)
            for s in core.STRATEGIES + (None,):
                cases.append((dt, m, k, n, s, a, b,
                              core.LayeredGemm(m, k, n, str(dt).replace(
                                  "torch.", ""), strategy=s)))
    counters.reset()
    results = []
    for dt, m, k, n, s, a, b, lg in cases:
        plan = lg.plan
        before_n, before_v = counters.read(), counters.variants()
        outs = [lg(a, b) for _ in range(LAYERED_CALLS)]
        after_n, after_v = counters.read(), counters.variants()
        results.append((outs, lg.plan is plan,
                        {k_: after_n[k_] - before_n[k_] for k_ in after_n
                         if after_n[k_] != before_n[k_]},
                        sorted(f"{k_}:{v}" for k_ in after_v
                               for v in after_v[k_]
                               if after_v[k_][v] != before_v[k_][v]
                               and not k_.startswith("pack"))))
    torch.cuda.synchronize()
    launches, variants = counters.read(), counters.variants()
    rows, fails, want = [], [], {}
    for (dt, m, k, n, s, a, b, lg), (outs, same_plan, dn, bodies) in zip(
            cases, results):
        key = (dt, m)
        if key not in want:
            want[key] = torch.matmul(a.float(), b.float())
        w_ = want[key]
        # a NaN counts as an infinite error, never as none
        err = max(float((o.float() - w_).abs().nan_to_num(nan=math.inf).max()
                        / w_.abs().max()) for o in outs)
        lim = 1e-4 if dt == torch.float32 else 1e-2
        want_n = {name: c * LAYERED_CALLS
                  for name, c in STRATEGY_LAUNCHES.get(lg.strategy, {}).items()}
        body = LAYERED_BODIES.get(lg.strategy, {}).get(m)
        ok_body = dt != torch.bfloat16 or body is None or bodies == [body]
        row = dict(dtype=str(dt).replace("torch.", ""), m=m, k=k, n=n,
                   asked=s, strategy=lg.strategy, rel_err=err,
                   same_plan=same_plan, launches=dn, want_launches=want_n,
                   bodies=bodies)
        if not (err <= lim and same_plan and dn == want_n and ok_body
                and all(o.dtype == dt for o in outs)):
            fails.append(row)
        rows.append(row)
    del results
    for row, (dt, m, k, n, s, a, b, lg) in zip(rows, cases):
        row["ms"] = time_ms(lambda i: lg(a, b), SURFACE_REPS)
        log(f"  LayeredGemm {row['dtype']} {m}x{k}x{n} strategy={s} "
            f"({lg.strategy}): {row['ms']:.3f} ms, rel err "
            f"{row['rel_err']:.2e}, launches {row['launches']} {row['bodies']}"
            f", one plan {row['same_plan']}")
    return dict(launches=launches, variants=variants, rows=rows, fails=fails)


def surface_main() -> int:
    """Phase 12's process: (a) ``facade_checks``, (b) ``layered_checks``.
    Prints one line, SURFACE_TAG + a JSON object."""
    import torch
    import repro_torch.core as core
    from repro_torch.configs import get_config
    from repro_torch.core import health
    from repro_torch.kernels import counted_wrappers
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    counters = Counters(counted_wrappers())
    facades = facade_checks(torch, counters, core, ref,
                            get_config("mixtral-8x22b"))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    layered = layered_checks(torch, counters, core)
    assert_healthy(health, "phase 12's process")
    out = dict(facades=facades, layered=layered, facades_s=t1 - t0,
               layered_s=time.perf_counter() - t1,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(SURFACE_TAG + json.dumps(out))
    return 1 if facades["fails"] or layered["fails"] else 0


def example_runs() -> dict:
    """The four example entry points on the card, each EXAMPLES run a
    process of its own, started together (the training example into a
    checkpoint directory of its own, removed after): each must exit 0, every
    error it prints must be within its gate, the serving runs' health
    reports must be empty and the training run's losses finite. Returns
    each run's seconds, errors and verdict."""
    import re
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="smoke_phase12_ckpt_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name, argv in EXAMPLES.items():
            script = ROOT / "examples" / f"{name.split()[0]}.py"
            extra = ["--ckpt-dir", ckpt] if name == "torch_train_lm" else []
            procs[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, str(script), *argv, *extra], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        out = {}
        for name, (t0, proc) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            errs = [(float(e), float(g)) for e, g in re.findall(ERR_LINE, stdout)]
            fails = []
            if proc.returncode != 0:
                fails.append(f"exit {proc.returncode}: {stderr[-2000:]}")
            if any(e > g for e, g in errs):
                fails.append(f"errors over their gates: {errs}")
            if len(errs) != EXAMPLE_ERRORS.get(name, 0):
                fails.append(f"{len(errs)} errors printed, want "
                             f"{EXAMPLE_ERRORS.get(name, 0)}")
            if name.startswith("torch_serve_lm") and \
                    "health_report: {} (healthy" not in stdout:
                fails.append("health report not empty")
            losses = [float(v) for v in re.findall(r"loss=([0-9.naif]+)", stdout)]
            if name == "torch_train_lm" and (
                    len(losses) != 4 or not all(math.isfinite(v) for v in losses)):
                fails.append(f"losses {losses}")
            out[name] = dict(seconds=time.perf_counter() - t0,
                             rc=proc.returncode, errors=errs, losses=losses,
                             fails=fails, tail=stdout[-1500:])
            log(f"  example {name}: exit {proc.returncode}, "
                f"{out[name]['seconds']:.1f} s, {len(errs)} errors within "
                f"their gates: {not any(e > g for e, g in errs)}"
                + (f"; FAILS {fails}" if fails else ""))
            if name == "torch_gemm_strategies":
                for line in stdout.splitlines():
                    log(f"    {line}")
        return out
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)


def phase_surface(card) -> dict:
    """Phase 12 (see SURFACE_TAG's comment): ``surface_main`` in a fresh
    process, then the examples (``example_runs``); fails unless every check
    of both holds. Returns the results."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.surface_main())"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    for line in lines:
        if not line.startswith(SURFACE_TAG):
            log(line)
    tagged = [ln for ln in lines if ln.startswith(SURFACE_TAG)]
    if len(tagged) != 1:
        log(run.stderr[-4000:])
        raise AssertionError(f"phase 12's process failed (exit "
                             f"{run.returncode})")
    res = json.loads(tagged[0][len(SURFACE_TAG):])
    t1 = time.perf_counter()
    res["examples"] = example_runs()
    res["examples_s"] = time.perf_counter() - t1
    res["phase_s"] = time.perf_counter() - t0
    res["card"] = card
    summary = dict(
        facades={r["case"]: {k: r[k] for k in (
            "gate_up_ms", "down_ms", "gate_up_bound_ms", "down_bound_ms",
            "gate_up_err", "down_err", "launches", "launches_by_body")}
            for r in res["facades"]["rows"]},
        counts=res["facades"]["counts"], capacity=res["facades"]["capacity"],
        layered=[{k: r[k] for k in ("dtype", "m", "asked", "strategy", "ms",
                                    "rel_err", "launches", "bodies")}
                 for r in res["layered"]["rows"]],
        examples={n: {k: r[k] for k in ("seconds", "rc", "errors", "fails")}
                  for n, r in res["examples"].items()},
        process_s=t1 - t0, examples_s=res["examples_s"],
        phase_s=res["phase_s"], peak_gb=res["peak_gb"], card=card)
    log(json.dumps({"surface": summary}))
    log(f"  phase 12 took {res['phase_s']:.1f} s (its process {t1 - t0:.1f} s, "
        f"the examples {res['examples_s']:.1f} s)")
    fails = (res["facades"]["fails"] + res["layered"]["fails"]
             + [(n, r["fails"]) for n, r in res["examples"].items() if r["fails"]])
    if run.returncode != 0 or fails:
        raise AssertionError(f"phase 12 (exit {run.returncode}): {fails}")
    return res


# Phase 9: guarded dispatch and the serving launcher. The zero-fault
# cases and the planted sites run at served shapes: olmo-1b's gate / up
# projection [2048, 8192] packed (K1) and raw (K7 at decode, K5 + K1 at the
# prefill's rows), mixtral-8x22b's gate / up pair at the decode envelope
# (K2); then one fault during a served generate, then the launcher.
GUARD_K, GUARD_N, GUARD_ROWS = 2048, 8192, (4, 512)
GUARD_GROUPED = (MIX_E, MIX_D, MIX_F, 8)      # E, K, N, C
GUARD_STEPS = 8
LAUNCH_SHAPE = (4, 128, 16)        # requests, prompt length, new tokens
LIFECYCLE_TRAIN = ["--preset", "tiny", "--steps", "4", "--log-every", "1"]
KERNEL_SITES = ("kernel_compile", "kernel_run")


def assert_healthy(health, where):
    """Fail the run, naming ``where`` and each degraded (spec, lowering), if
    guarded dispatch recorded any degradation. The only degradations a
    passing run accepts are phase 9's planted ones, cleared where planted."""
    report = health.health_report()
    if report:
        log(f"  health report after {where}: {json.dumps(report)}")
        raise AssertionError(f"{where}: guarded dispatch degraded "
                             f"{len(report)} contraction(s): "
                             + "; ".join(report))


@contextlib.contextmanager
def healthy(health, where):
    """Run a phase; a failure is logged with the phase's name (and the
    notes that name a failing contraction's spec), and whether it passed
    or failed, its health report must be empty afterwards (a degradation
    is named even where it made the phase fail some other check first)."""
    try:
        yield
    except Exception as exc:
        log(f"  {where} failed: {type(exc).__name__}: {exc}"
            + "".join(f"\n    {note}" for note in getattr(exc, "__notes__", [])))
        raise
    finally:
        assert_healthy(health, where)


def guard_cases(torch, m, device, k=GUARD_K, n=GUARD_N,
                rows=GUARD_ROWS, grouped=GUARD_GROUPED, seed=9) -> list:
    """Phase 9's cases, bf16: each ``dict(label, spec, run, bodies, raw)``
    where ``run(strategy)`` calls the served entry (``gemm.linear``, and
    ``GroupedPackedWeight.silu_gate`` under auto, ``gemm.contract`` when a
    strategy is named) and ``bodies`` the launches by body the zero-fault
    auto call must make. ``m`` holds the port's modules."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16

    def rand(*shape):
        return (torch.randn(*shape, generator=gen, device=device) * 0.05).to(bf16)
    w = rand(k, n)
    pw = m["layered"].PackedWeight.pack(w)
    cases = []
    for rows_ in rows:
        x = rand(rows_, k)
        k1 = "tc_stream" if rows_ <= 16 else "wgmma"
        for weight, raw in ((pw, False), (w, True)):
            spec = m["ctr"].ContractionSpec.dense(rows_, k, n, bf16, w=weight,
                                                  out_dtype=bf16)
            if raw and rows_ <= 16:
                bodies = {"gemm_tiled": {"tc_stream": 1}}
            elif raw:
                bodies = {"pack_b": {"tma_copy": 1},
                          "gemm_packed_fused_a": {k1: 1}}
            else:
                bodies = {"gemm_packed_fused_a": {k1: 1}}
            cases.append(dict(
                label=f"{'raw' if raw else 'packed'} [{k}, {n}] at M={rows_}",
                spec=spec, raw=raw, bodies=bodies,
                run=lambda s, x=x, wt=weight: m["gemm"].linear(
                    x, wt, strategy=s or "auto")))
    e, gk, gn, c = grouped
    gate = m["layered"].GroupedPackedWeight.pack(rand(e, gk, gn), n_b_streams=2)
    up = m["layered"].GroupedPackedWeight.pack(rand(e, gk, gn), n_b_streams=2)
    a = rand(e, 1, c, gk)
    counts = torch.randint(0, c + 1, (e, 1), generator=gen, device=device,
                           dtype=torch.int32)
    counts[0, 0] = c                       # one full segment, one empty
    counts[-1, 0] = 0
    spec = m["ctr"].ContractionSpec.grouped(
        e, c, gk, gn, bf16, w=gate, epilogue="silu_gate", counts=True)

    def run_pair(s):
        if s is None:
            return gate.silu_gate(up, a, counts=counts)
        out = m["gemm"].contract(spec, a.transpose(0, 1), gate, w2=up,
                                 counts=counts.t(), strategy=s)
        return out.transpose(0, 1)
    cases.append(dict(label=f"grouped pair E={e} [{gk}, {gn}] at C={c}, counts",
                      spec=spec, raw=False, run=run_pair,
                      bodies={"gemm_grouped_packed_ragged": {"tc_stream": 1}}))
    return cases


def raised_naming(exc_type, spec, winner, call, what) -> str:
    """``call()`` must raise ``exc_type`` whose message or notes name
    ``spec`` and the lowering ``winner`` (the card's guarded runner notes
    both on a failure it lets through). Returns a line saying what
    raised."""
    try:
        call()
    except exc_type as exc:
        text = "\n".join([str(exc)] + list(getattr(exc, "__notes__", [])))
        if spec.describe() not in text or repr(winner) not in text:
            raise AssertionError(f"{what}: {type(exc).__name__} does not name "
                                 f"{spec.describe()} and {winner!r}: {text}")
        return f"{winner} raised {type(exc).__name__}, naming the spec"
    raise AssertionError(f"{what}: did not raise {exc_type.__name__}")


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` within the block, restored after."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def guard_checks(torch, m, counters, cases) -> dict:
    """Phase 9 (a) and (b) over ``cases``: (a) with no fault the auto
    output is bitwise the named winner's, launched on the bodies the case
    names, and nothing degrades; (b) on the card the chain is the winner
    alone, so with ``kernel_compile`` / ``kernel_run`` armed at every hit
    auto raises ``InjectedFault`` naming the spec and the winner, as the
    named winner does, and nothing is recorded; ``pack`` under the env
    override ``tiling_packing_fused`` (raw weights) raises the same way.
    Returns what each case ran, by site. ``m`` holds the port's modules."""
    ctr, faults, health = m["ctr"], m["faults"], m["health"]
    walked = {}
    for case in cases:
        spec, run, label = case["spec"], case["run"], case["label"]
        winner = ctr.dispatch(spec, on_card=True).name
        rec = walked.setdefault(label, {})
        # (a) zero fault
        health.clear_health()
        counters.reset()
        got = run(None)
        torch.cuda.synchronize()
        bodies = {name: launches_by_body(counters, name)
                  for name in case["bodies"]}
        want = run(winner)
        if not torch.equal(got, want) or health.HEALTH:
            raise AssertionError(f"phase 9 (a) {label}: auto != named {winner} "
                                 f"or degraded {health.health_report()}")
        if bodies != case["bodies"]:
            raise AssertionError(f"phase 9 (a) {label}: launched {bodies}, "
                                 f"want {case['bodies']}")
        rec["none"] = f"{winner}, bitwise its named output"
        # (b) the kernel sites, every hit: the winner alone, raising
        for site in KERNEL_SITES:
            with faults.inject(site):
                rec[site] = raised_naming(faults.InjectedFault, spec, winner,
                                          lambda: run(None),
                                          f"phase 9 (b) {label} {site}")
                try:
                    run(winner)
                except faults.InjectedFault:
                    pass
                else:
                    raise AssertionError(f"phase 9 (b) {label}: named {winner} "
                                         f"did not raise under {site}")
        if case["raw"]:
            with env_set("REPRO_TORCH_GEMM_STRATEGY", "tiling_packing_fused"), \
                    faults.inject("pack"):
                rec["pack"] = raised_naming(
                    faults.InjectedFault, spec, "tiling_packing_fused",
                    lambda: run(None), f"phase 9 (b) {label} pack")
        if health.HEALTH:
            raise AssertionError(f"phase 9 (b) {label}: recorded "
                                 f"{health.health_report()}")
    return walked


def guard_scale_grid(torch, m, k=GUARD_K, n=GUARD_N, rows=GUARD_ROWS) -> dict:
    """Phase 9 (b), ``scale_grid`` under the numerics guard on an int8
    packed [k, n] weight at each of ``rows``: auto and the named
    ``packed_weight`` raise ``NumericsError`` naming the spec, and nothing
    is recorded."""
    ctr, faults, health = m["ctr"], m["faults"], m["health"]
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    pw8 = m["layered"].PackedWeight.pack(
        torch.randn(k, n, generator=gen, device=DEVICE) * 0.05, quantize="int8")
    walked = {}
    for rows_ in rows:
        x = torch.randn(rows_, k, generator=gen, device=DEVICE).to(
            torch.bfloat16)
        spec = ctr.ContractionSpec.dense(rows_, k, n, torch.bfloat16, w=pw8,
                                         out_dtype=torch.bfloat16)
        label = f"int8 packed [{k}, {n}] at M={rows_}"
        with env_set(health.ENV_NUMERICS_GUARD, "1"), faults.inject("scale_grid"):
            ran = raised_naming(health.NumericsError, spec, "packed_weight",
                                lambda: m["gemm"].linear(x, pw8),
                                f"phase 9 (b) {label} scale_grid")
            try:
                m["gemm"].linear(x, pw8, strategy="packed_weight")
            except health.NumericsError:
                pass
            else:
                raise AssertionError(f"phase 9 (b) {label}: named packed_weight "
                                     f"did not raise NumericsError")
        if health.HEALTH:
            raise AssertionError(f"phase 9 (b) {label} scale_grid: recorded "
                                 f"{health.health_report()}")
        walked[label] = {"scale_grid": ran}
    return walked


def guard_serve(torch, m, cfgs, models, serve) -> dict:
    """Phase 9 (c): ``kernel_run`` armed during ``Engine.generate`` on
    full-width olmo-1b with packed weights, prompt PROMPT, GUARD_STEPS
    greedy steps. At its first hit (the first contraction of the prefill
    graph's capture, the engine's first call having been its warm-up)
    the call raises naming the spec, nothing is recorded, and the engine's
    next call gives the tokens of a call made before the fault. On a fresh
    engine, armed at the first hit past the prefill's, it raises at the
    decode graph's warm-up, naming the spec, keeps no graph, and the next
    call warms up again, captures at its second step and gives those tokens
    again."""
    health, faults = m["health"], m["faults"]
    cfg = dataclasses.replace(cfgs.get_config("olmo-1b"),
                              compute_dtype="bfloat16")
    model = models.build(cfg, device=DEVICE)
    params = bf16_tree(torch, model.init(0))

    def engine_():
        return serve.Engine(model, params, serve.ServeConfig(
            max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16"),
            device=DEVICE)
    prompt = torch.randint(0, cfg.vocab_size, PROMPT,
                           generator=torch.Generator().manual_seed(1))

    def generate(engine):
        return engine.generate({"tokens": prompt}, max_new_tokens=GUARD_STEPS)

    def raises(engine, nth):
        with faults.inject("kernel_run", nth=nth):
            try:
                generate(engine)
            except faults.InjectedFault as exc:
                return ("\n".join(getattr(exc, "__notes__", [])),
                        faults.hits("kernel_run"))
        raise AssertionError(f"phase 9 (c): generate did not raise under "
                             f"kernel_run:{nth}")
    engine = engine_()
    want = generate(engine)
    raised, _ = raises(engine, 1)
    after = generate(engine)
    fresh = engine_()
    prefill_hits = 7 * cfg.num_layers + 1
    raised_warm, hit = raises(fresh, prefill_hits + 1)
    kept = decode_graph(fresh, PROMPT[0]).graph is not None
    after_warm = generate(fresh)
    replays = decode_graph(fresh, PROMPT[0]).replays
    log(f"  (c) kernel_run:1 during generate ({PROMPT[0]}x{PROMPT[1]} + "
        f"{GUARD_STEPS} steps, packed): raised in the prefill, {raised!r}; "
        f"report {json.dumps(health.health_report())}; the next call's tokens "
        f"equal the first's: {bool((after == want).all())}")
    log(f"  (c) kernel_run:{prefill_hits + 1} on a fresh engine: raised at hit "
        f"{hit}, the decode graph's warm-up, {raised_warm!r}; graph kept "
        f"{kept}; the next call warmed up, captured and replayed {replays} "
        f"times, its "
        f"tokens equal the first's: {bool((after_warm == want).all())}")
    if (health.HEALTH or "lowering" not in raised or after.shape != want.shape
            or not (after == want).all() or want.min() < 0
            or want.max() >= cfg.vocab_size):
        raise AssertionError(f"phase 9 (c): raised {raised!r}, report "
                             f"{health.health_report()}, tokens {after.shape}")
    if ("lowering" not in raised_warm or hit != prefill_hits + 1 or kept
            or replays != GUARD_STEPS - 1 or not (after_warm == want).all()):
        raise AssertionError(f"phase 9 (c): at the warm-up raised "
                             f"{raised_warm!r} at hit {hit}, graph kept {kept}, "
                             f"{replays} replays")
    del engine, fresh, model, params
    torch.cuda.empty_cache()
    return {"raised": raised, "raised_at_warm_up": raised_warm,
            "tokens_0": want[0].tolist()}


def guard_launcher(torch, m, health, card) -> dict:
    """Phase 9 (d): the serving launcher on the card with no device flag,
    full-width olmo-1b (raw weights, random from seed 0): its tokens/s and
    ms / decode step; then the lifecycle, ``launch.train.main`` at the tiny
    preset into a checkpoint and ``launch.serve`` serving it, whose greedy
    tokens must equal an Engine's on ``checkpoint.restore``'s params."""
    import tempfile
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt
    requests, prompt, new = LAUNCH_SHAPE
    shape = ["--requests", str(requests), "--prompt-len", str(prompt), "--new",
             str(new)]
    out = {}
    with healthy(health, "phase 9 (d), the serving launcher"):
        t0 = time.perf_counter()
        args = ["--arch", "olmo-1b", "--preset", "full"] + shape
        res = launch_serve.run(args)
        out["launcher"] = dict(args=" ".join(args),
                               tok_s=res["tok_s"], ms_per_step=res["ms_per_step"],
                               graphed=res["graphed"],
                               seconds=time.perf_counter() - t0, card=card)
        log(f"  (d) launch.serve {' '.join(args)}: "
            f"{res['tok_s']:.1f} tok/s, {res['ms_per_step']:.2f} ms/decode-step "
            f"({'graph' if res['graphed'] else 'eager'}; {card}); "
            f"{out['launcher']['seconds']:.1f} s")
        if not res["graphed"]:
            raise AssertionError("phase 9 (d): the launcher decoded eagerly")
        del res
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="phase9_") as d:
            t0 = time.perf_counter()
            if launch_train.main(LIFECYCLE_TRAIN + ["--ckpt-dir", d]) != 0:
                raise AssertionError("phase 9 (d): launch.train.main failed")
            args = ["--preset", "tiny", "--ckpt-dir", d] + shape
            res = launch_serve.run(args)
            cfg = launch_train.preset_config("olmo-1b", "tiny")
            model = m["models"].build(cfg, device=DEVICE)
            restored, step = ckpt.restore(d, {"params": model.init(1)})
            engine = m["serve"].Engine(
                model, restored["params"],
                m["serve"].ServeConfig(max_len=prompt + new + 8), device=DEVICE)
            want = engine.generate(
                launch_serve.request_batch(cfg, requests, prompt), new)
        same = bool((res["tokens"] == want).all())
        out["lifecycle"] = dict(train=" ".join(LIFECYCLE_TRAIN), serve=" ".join(args),
                                step=step, same_tokens=same,
                                seconds=time.perf_counter() - t0)
        log(f"  (d) lifecycle: trained {step} steps (tiny), served the checkpoint "
            f"through launch.serve: tokens equal to an Engine on the restored "
            f"params: {same}; {out['lifecycle']['seconds']:.1f} s")
        if not same or step != 4:
            raise AssertionError("phase 9 (d): the launcher's tokens differ from "
                                 "the restored params' Engine")
    return out


def phase_guard(torch, m, counters, cfgs, models, serve, card) -> dict:
    """Phase 9: guarded dispatch on the card ((a) no fault, (b) every
    site, (c) one fault while serving) and the serving launcher (d)."""
    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    walked = guard_checks(torch, m, counters, guard_cases(torch, m, DEVICE))
    walked.update(guard_scale_grid(torch, m))
    for label, ran in walked.items():
        log(f"  (a)/(b) {label}: " + "; ".join(
            f"{site}: {what}" for site, what in ran.items()))
    res["chains"] = walked
    res["checks_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["serve_fault"] = guard_serve(torch, m, cfgs, models, serve)
    res["serve_fault"]["seconds"] = time.perf_counter() - t0
    res.update(guard_launcher(torch, m, m["health"], card))
    res["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"guard": res, "card": card}))
    log(f"  phase 9 took {res['phase_s']:.1f} s")
    return res


# The quantized served cells: olmo-1b with phase 2's weights as int8 (tile
# scales) and int4 (col scales), mixtral-8x22b with phase 3's as int8.
OLMO_QUANT = ("int8", "int4:col")
MIXTRAL_QUANT = "int8"
# The quantized bodies in a profile, by a piece of their names (K1's
# decode and prefill bodies, K2's, the split reductions after them).
KQ_KERNEL_TAGS = {"K1 tc_stream_q": "::quant_stream", "K1 wgmma_q": "::quant_wgmma",
                  "splitk_reduce": "splitk_reduce",
                  "K2 tc_stream_q": "grouped_quant_stream",
                  "K2 wgmma_q": "grouped_quant_wgmma", "K2 reduce": "grouped_reduce",
                  "earlier quantized bodies": "fused_a_mma"}


def quant_load(torch, counters, serve, model, params, quantize, wrappers):
    """Engine construction with ``quantize`` (load-time quantizing in plain
    torch, then K5), counted and timed. Returns (engine, load launches, its
    launches by body, the load's ms)."""
    counters.reset()
    torch.cuda.synchronize()
    t_load = time.perf_counter()
    engine = serve.Engine(model, params, serve.ServeConfig(
        max_len=MAX_LEN, pack_weights=True, cache_dtype="bfloat16",
        quantize=quantize), device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t_load
    load = counters.read()
    if load != counters.only(**wrappers):
        raise AssertionError(f"load-time launch counts {load} (want {wrappers})")
    return engine, load, {name: launches_by_body(counters, name)
                          for name in wrappers}, t_load * 1e3


def phase_serve_quant(torch, gp, counters, serve, packed_run, quantize):
    """olmo-1b at full width served with phase 2's bf16 weights quantized at
    load (``ServeConfig(pack_weights=True, quantize=...)``): every K1
    launch on the quantized TMA bodies (wgmma_q at prefill, tc_stream_q for
    the prefill's LM head and at decode, nothing on the earlier bodies), prefill
    logits against the plain versions on the same quantized weights on the
    card (the gate), and against phase 2's float logits (quantization
    error, reported). Returns (load launches, launches of the counted run,
    timings)."""
    model, params, float_logits, prompt = packed_run
    cfg = model.cfg
    per_forward = 7 * cfg.num_layers + 1
    engine, load, load_bodies, load_ms = quant_load(
        torch, counters, serve, model, params, quantize,
        dict(pack_b=per_forward))
    log(f"  olmo-1b {quantize}: Engine construction (quantize + pack, "
        f"synchronized) {load_ms:.1f} ms; load launches {load}; K5 by body "
        f"{load_bodies}; {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    counters.reset()
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = counters.read()
    bodies = launches_by_body(counters)
    want_bodies = dict(tc_stream_q=1 + per_forward * STEPS,
                       wgmma_q=7 * cfg.num_layers)
    log(f"  generate {PROMPT[0]}x{PROMPT[1]} + {STEPS} steps: {t_gen * 1e3:.1f} ms; "
        f"launches {launches}; K1 by body {bodies} (want {want_bodies})")
    if launches != counters.only(gemm_packed_fused_a=per_forward * (STEPS + 1)):
        raise AssertionError(f"launch counts {launches}")
    if bodies != want_bodies:
        raise AssertionError(f"K1 launches by body {bodies}")
    check_tokens(tokens, cfg)
    logits_k = engine.prefill_request(prompt[0])[0].clone()
    with plain_kernels(gp, None), eager_steps(engine):
        logits_p, _ = engine.prefill_request(prompt[0])
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite logits")
    rel, max_err, same_tok = compare_logits(torch, logits_k, logits_p)
    rel_q, err_q, same_q = compare_logits(torch, logits_k, float_logits)
    scale = float(float_logits.float().abs().max())
    # The gate is phase 2's: bf16 activations rounded in other orders over
    # 16 layers, 5e-2 relative (Frobenius) and the same greedy token.
    log(f"  prefill logits kernel vs plain (same quantized weights): rel_fro="
        f"{rel:.3e} (limit 5e-2), max_abs_err={max_err:.3e}, same argmax "
        f"{same_tok}/1; against phase 2's float logits: rel_fro={rel_q:.3e}, "
        f"max_abs_err={err_q:.3e} = {err_q / scale:.3e} of the logit scale "
        f"{scale:.3f}, same argmax {same_q}/1 (reported)")
    if rel > 5e-2 or same_tok != 1:
        raise AssertionError("served logits disagree with the plain version")
    timings = serve_timings(torch, engine, prompt, STEPS, KQ_KERNEL_TAGS,
                            counters, f"olmo-1b {quantize}")
    timings.update(rel_fro=rel, rel_fro_vs_float=rel_q,
                   max_err_vs_float_of_scale=err_q / scale,
                   first_generate_ms=t_gen * 1e3, k1_launches_by_body=bodies,
                   load_ms=load_ms, k5_load_launches_by_body=load_bodies)
    del engine
    return load, launches, timings


def phase_mixtral_quant(torch, gp, gg, counters, cfgs, models, serve,
                        float_logits):
    """mixtral-8x22b (4 of 56 layers, published widths) with phase 3's
    weights drawn again from its seed and quantized at load: K1 on
    wgmma_q / tc_stream_q, K2 on wgmma_q at prefill and tc_stream_q at
    decode, nothing on the earlier bodies; prefill logits against the plain
    versions on the same quantized weights (phase 3's gate) and against
    phase 3's float logits (reported). Returns (load launches, launches of
    the counted run, timings)."""
    cfg = dataclasses.replace(cfgs.get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS,
                              compute_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    model = models.build(cfg, device=DEVICE)
    params = model.init(0)
    engine, load, load_bodies, load_ms = quant_load(
        torch, counters, serve, model, params, MIXTRAL_QUANT,
        dict(pack_b=4 * cfg.num_layers + 1, pack_b_grouped=3 * cfg.num_layers))
    del params
    torch.cuda.empty_cache()
    log(f"  mixtral-8x22b {MIXTRAL_QUANT}: Engine construction (quantize + "
        f"pack, synchronized) {load_ms:.1f} ms; load launches {load}; K5 by "
        f"body {load_bodies}; peak {torch.cuda.max_memory_allocated() / 1e9:.1f} "
        f"GB, packed {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    gen = torch.Generator(device="cpu").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)
    want_k1 = (4 * cfg.num_layers + 1) * (STEPS + 1)
    want_k2 = 2 * cfg.num_layers * (STEPS + 1)
    counters.reset()
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, max_new_tokens=STEPS)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = counters.read()
    bodies = launches_by_body(counters)
    bodies_k2 = launches_by_body(counters, "gemm_grouped_packed_ragged")
    want_bodies = dict(tc_stream_q=1 + (4 * cfg.num_layers + 1) * STEPS,
                       wgmma_q=4 * cfg.num_layers)
    want_bodies_k2 = dict(tc_stream_q=2 * cfg.num_layers * STEPS,
                          wgmma_q=2 * cfg.num_layers)
    log(f"  generate 4x128 + {STEPS} steps: {t_gen * 1e3:.1f} ms; launches "
        f"{launches} (want K1 {want_k1}, K2 {want_k2}); K1 by body {bodies} "
        f"(want {want_bodies}); K2 by body {bodies_k2} (want {want_bodies_k2})")
    if launches != counters.only(gemm_packed_fused_a=want_k1,
                                 gemm_grouped_packed_ragged=want_k2):
        raise AssertionError(f"launch counts {launches}")
    if bodies != want_bodies or bodies_k2 != want_bodies_k2:
        raise AssertionError(f"launches by body {bodies}, {bodies_k2}")
    check_tokens(tokens, cfg)
    check = mixtral_prefill_check(torch, gp, gg, engine, prompt, cfg)
    rel_q, err_q, same_q = compare_logits(torch, check["logits"], float_logits)
    scale = float(float_logits.float().abs().max())
    log(f"  prefill logits against phase 3's float logits: rel_fro={rel_q:.3e}, "
        f"max_abs_err={err_q:.3e} = {err_q / scale:.3e} of the logit scale "
        f"{scale:.3f}, same argmax {same_q}/4 (reported)")
    timings = serve_timings(torch, engine, prompt, STEPS, KQ_KERNEL_TAGS,
                            counters, f"mixtral-8x22b {MIXTRAL_QUANT}")
    timings.update(rel_fro_pinned=check["rel_p"], rel_fro_free=check["rel_f"],
                   expert_choice_flips_free=check["flips_free"],
                   rel_fro_vs_float=rel_q, max_err_vs_float_of_scale=err_q / scale,
                   first_generate_ms=t_gen * 1e3, k1_launches_by_body=bodies,
                   k2_launches_by_body=bodies_k2, load_ms=load_ms,
                   k5_load_launches_by_body=load_bodies,
                   prefill_counts=check["counts"])
    del engine, check
    torch.cuda.empty_cache()
    return load, launches, timings


def served_attention(torch, chunked, cfgs, shapes) -> list:
    """Served attention alone: ``chunked`` (the served models'
    ``models.layers.chunked_attention``) in bf16 at olmo-1b's widths (16
    heads x 128) at its served prefill (4 x 128), its decode (4 rows
    against phase 2's ring cache of MAX_LEN slots at the last step, as
    ``decode_attention`` calls it) and one prefill_32k sequence; causal.
    Each output is checked finite and of its shape; times from CUDA
    events."""
    cfg = cfgs.get_config("olmo-1b")
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    long = shapes.SHAPES["prefill_32k"].seq_len
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    b, s = PROMPT
    pos = torch.full((b,), s + STEPS - 1, dtype=torch.long, device=DEVICE)
    slot_ids = torch.arange(MAX_LEN, device=DEVICE)[None]
    k_pos = pos[:, None] - ((pos[:, None] - slot_ids) % MAX_LEN)
    decode_kw = dict(causal=True, q_positions=pos[:, None], k_positions=k_pos,
                     kv_valid=k_pos >= 0, chunk=1)
    cases = [("prefill", b, s, s, dict(causal=True)),
             ("decode", b, 1, MAX_LEN, decode_kw),
             ("prefill_32k", 1, long, long, dict(causal=True))]
    rows = []
    for tag, bb, sq, skv, kw in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
                   for shape in ((bb, sq, h, d), (bb, skv, hkv, d), (bb, skv, hkv, d)))
        out = chunked(q, k, v, **kw)
        torch.cuda.synchronize()
        if tuple(out.shape) != (bb, sq, h, d) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"served attention {tag}: {tuple(out.shape)}")
        del out
        t = time_ms(lambda i: chunked(q, k, v, **kw), 3 if sq > 1024 else 20)
        rows.append(dict(shape=tag, b=bb, sq=sq, skv=skv, heads=h, kv_heads=hkv,
                         head_dim=d, ms=t))
        log(f"  served attention (chunked_attention) {tag} B={bb} Sq={sq} "
            f"Skv={skv}: {t:.4f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def attention_shapes(cfgs, shapes):
    """Phase 6: (tag, config, B, Sq, Skv, window, what it is and its cut).
    Lengths and batches from ``configs.shapes.SHAPES``. decode_32k runs at
    its global batch (A4's K and V are 2 x 17.2 GB). prefill_32k is cut to
    one sequence for the run's time, not for memory: the plain version,
    called three times a shape (check, probe, timing), takes about 0.3 s a
    sequence there on an H100, so 32 would add about a minute a shape."""
    olmo, mix = cfgs.get_config("olmo-1b"), cfgs.get_config("mixtral-8x22b")
    pre, dec = shapes.SHAPES["prefill_32k"], shapes.SHAPES["decode_32k"]
    w = mix.sliding_window
    return [
        ("A1", olmo, PROMPT[0], PROMPT[1], PROMPT[1], None,
         f"olmo-1b's served prefill ({PROMPT[0]} x {PROMPT[1]}, phase 2)"),
        ("A2", olmo, PROMPT[0], 1, PROMPT[1] + STEPS, None,
         "olmo-1b's served decode, last step (phase 2)"),
        ("A3", olmo, 1, pre.seq_len, pre.seq_len, None,
         f"prefill_32k, global batch {pre.global_batch} -> 1 (run time)"),
        ("A4", olmo, dec.global_batch, 1, dec.seq_len, None,
         f"decode_32k, global batch {dec.global_batch}"),
        ("A5", mix, 1, pre.seq_len, pre.seq_len, w,
         f"prefill_32k, window {w}, global batch {pre.global_batch} -> 1 "
         f"(run time)"),
        ("A6", mix, dec.global_batch, 1, dec.seq_len, w,
         f"decode_32k, window {w}, global batch {dec.global_batch}"),
    ]


def attention_inputs(torch, gen, cfg, b, sq, skv):
    """Unit-normal bf16 q [B,Sq,H,D], k / v [B,Skv,Hkv,D] at ``cfg``'s head
    widths, made on the card from ``gen``."""
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return tuple(torch.randn(shape, generator=gen, device=DEVICE,
                             dtype=torch.bfloat16)
                 for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def attention_verdict(torch, fa, out, q, k, v, window, want, want_probe):
    """Phase 6's check of one K4 output ``out`` (of q, k, v) against the
    plain version's ``want``, plus the uniform-weight probe: K4 on q = 0
    against ``want_probe``. The probe's call is a check and is not counted
    on the path. Returns (ok, the errors by name)."""
    ok, err, norm, why = attention_close(out, want, *ATTN_TOL["bfloat16"])
    probe = fa.flash_attention(torch.zeros_like(q), k, v, causal=True,
                               window=window)
    torch.cuda.synchronize()
    ok_p, err_p, norm_p, why_p = attention_close(probe, want_probe,
                                                 *ATTN_PROBE_TOL)
    failed = ([f"random {why}"] if why else []) + (
        [f"probe {why_p}"] if why_p else [])
    if out.shape != q.shape or not bool(torch.isfinite(out).all()):
        failed.append("shape or finite")
    return not failed, dict(max_abs_err=err, norm_err=norm,
                            probe_max_abs_err=err_p, probe_norm_err=norm_p,
                            failed=", ".join(failed))


def attention_wants(torch, fa, q, k, v, window):
    """The plain version's outputs for phase 6's check and its probe."""
    return (fa.flash_attention_plain(q, k, v, causal=True, window=window),
            fa.flash_attention_plain(torch.zeros_like(q), k, v, causal=True,
                                     window=window))


def attention_bound_ms(b, sq, skv, h, hkv, d, causal, window, item=2):
    """Least time of one attention call on these inputs: 4 * B * H * D per
    visible (query, key) pair over the bf16 tensor-core peak, against q, the
    K / V rows that some query sees, and the output, each moved once, over
    the HBM rate. Returns (ms, bound_by, pairs per head, keys seen)."""
    import numpy as np
    q_pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(skv - 1, q_pos) if causal else np.full(sq, skv - 1)
    lo = (np.maximum(0, q_pos - window + 1) if window is not None
          else np.zeros(sq, dtype=np.int64))
    live = hi >= lo
    pairs = int((hi - lo + 1)[live].sum())
    seen = np.zeros(skv + 1, dtype=np.int64)      # keys some query sees
    np.add.at(seen, lo[live], 1)
    np.add.at(seen, hi[live] + 1, -1)
    keys = int((np.cumsum(seen)[:skv] > 0).sum())
    flops = 4.0 * b * h * d * pairs
    nbytes = item * (2 * b * sq * h * d + 2 * b * keys * hkv * d)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes", pairs, keys)


def sdpa_yardstick(torch, ref, q, k, v, window, reps):
    """``F.scaled_dot_product_attention`` on the same inputs (the yardstick
    only: the port never calls it), with ``enable_gqa=True``, ``is_causal``
    where Sq == Skv and there is no window, else an explicit boolean mask of
    the right-aligned positions. Tries the flash, cuDNN, memory-efficient
    and math backends in turn (math only where its f32 scores fit) and
    times the first that takes the call, by CUDA events, by stream-backed
    events (``backed_ms``) and by torch.profiler (``launch_ms``). Returns
    (ms, device ms, the profiler's (ms, kept, why not), backend, output,
    what the others said)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if sq == skv and window is None:
        kw = dict(is_causal=True)
    else:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
        kw = dict(attn_mask=ref.attention_mask(
            q_pos, torch.arange(skv, device=q.device), causal=True,
            window=window))
    refused = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and b * h * sq * skv * 4 > 8e9:
            refused.append("MATH: f32 scores over 8 GB")
            continue
        try:
            with sdpa_kernel([backend]):
                def call(i):
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True, **kw)
                out = call(0).transpose(1, 2)
                torch.cuda.synchronize()
                return (time_ms(call, reps), backed_ms(call, reps),
                        launch_ms(call, reps), backend.name, out, refused)
        except RuntimeError as exc:
            refused.append(f"{backend.name}: {str(exc).splitlines()[0][:120]}")
    return None, None, (None, 0, None), None, None, refused


# The body each phase-6 shape must take: the TMA + wgmma prefill body, the
# TMA-ring decode body.
ATTN_SHAPE_BODY = {"A1": "wgmma", "A2": "stream", "A3": "wgmma",
                   "A4": "stream", "A5": "wgmma", "A6": "stream"}


def phase_attention(torch, fa, ops, counters, ref, cfgs, shapes):
    """Long-context attention through ``ops.attention`` at full head width
    (bf16): one counted call a shape (counts set to 0 just before it, read
    just after: exactly one K4 launch, on the body of ``ATTN_SHAPE_BODY``,
    which must be the one ``attention_body`` names), checked against the
    plain version by ``attention_verdict`` (rows that see no key excepted:
    none here), then timed beside its bound, the plain version and SDPA,
    K4 and SDPA both by CUDA events, by stream-backed events (``backed_ms``,
    the device time: late in the process the profiler loses records) and
    by torch.profiler (``launch_ms``: K4 is one launch a call; null with
    the reason where it lost a record). Returns (launches, rows, max abs
    err)."""
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    total = {name: 0 for name in counters.fns}
    rows, max_err, fails = [], 0.0, []
    for tag, cfg, b, sq, skv, window, what in attention_shapes(cfgs, shapes):
        h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        def make():
            return attention_inputs(torch, gen, cfg, b, sq, skv)
        q, k, v = make()
        counters.reset()
        out = ops.attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        launches = counters.read()
        if launches != counters.only(flash_attention=1):
            raise AssertionError(f"{tag}: ops.attention launched {launches}")
        bodies = {v: c for v, c in fa.flash_attention.variants.items() if c}
        body = ATTN_SHAPE_BODY[tag]
        if (bodies != {body: 1}
                or fa.attention_body(q, k, v, True, window) != body):
            raise AssertionError(f"{tag}: K4 ran {bodies}, route "
                                 f"{fa.attention_body(q, k, v, True, window)}"
                                 f", must be {body}")
        for name, c in launches.items():
            total[name] += c
        want, want_probe = attention_wants(torch, fa, q, k, v, window)
        ok, errs = attention_verdict(torch, fa, out, q, k, v, window, want,
                                     want_probe)
        err = errs["max_abs_err"]
        max_err = max(max_err, err)
        if not ok:
            fails.append(tag)
        t_b, by, pairs, keys = attention_bound_ms(b, sq, skv, h, hkv, d, True,
                                                  window)
        # Small shapes rotate over copies (>= 128 MB in all) so that each
        # call finds its operands in HBM, not in the 50 MB L2.
        set_bytes = 2 * (q.numel() + k.numel() + v.numel())
        copies = max(1, min(16, math.ceil(128e6 / set_bytes)))
        sets = [(q, k, v)] + [make() for _ in range(copies - 1)]
        reps = 20 if t_b < 0.1 else 5
        def kernel(i):
            return ops.attention(*sets[i % copies], causal=True, window=window)
        t_k, t_dev = time_ms(kernel, reps), backed_ms(kernel, reps)
        t_prof, kept, lost = launch_ms(kernel, reps)
        t_p = time_ms(lambda i: fa.flash_attention_plain(
            *sets[i % copies], causal=True, window=window), 1 if t_b > 1 else 3)
        del sets
        t_l, t_l_dev, (t_l_prof, kept_l, lost_l), backend, lib_out, refused = (
            sdpa_yardstick(torch, ref, q, k, v, window, reps))
        lib_err = (None if lib_out is None else
                   float((lib_out.float() - want.float()).abs().max()))
        rows.append(dict(tag=tag, model=cfg.name, what=what, b=b, sq=sq,
                         skv=skv, h=h, hkv=hkv, d=d, window=window, body=body,
                         ms=t_k, device_ms=t_dev, profiler_ms=t_prof,
                         profiler_records=f"{kept}/{reps}", profiler_lost=lost,
                         plain_ms=t_p, bound_ms=t_b,
                         bound_by=by, library_ms=t_l, library_device_ms=t_l_dev,
                         library_profiler_ms=t_l_prof, library_profiler_lost=lost_l,
                         library_backend=backend,
                         library_refused=refused, library_max_abs_err=lib_err,
                         **errs, launches=launches["flash_attention"]))
        log(f"  {tag} {cfg.name} B={b} Sq={sq} Skv={skv} H={h}/{hkv} D={d} "
            f"window={window} ({what}; {pairs} visible pairs a head, {keys} "
            f"keys seen): max_abs_err={err:.3e} norm {errs['norm_err']:.2e}, "
            f"probe {errs['probe_max_abs_err']:.2e} / norm "
            f"{errs['probe_norm_err']:.2e} "
            f"{'ok' if ok else 'FAIL ' + errs['failed']}; {body}: kernel "
            f"{t_k:.4f} ms (device {t_dev:.4f}; profiler {fmt_ms(t_prof, lost)}), "
            f"bound {t_b:.4f} ms ({by}), plain {t_p:.4f} ms, SDPA "
            + (f"{t_l:.4f} ms (device {t_l_dev:.4f}; profiler "
               f"{fmt_ms(t_l_prof, lost_l)}; {backend}, max_abs_err "
               f"{lib_err:.2e})" if t_l is not None else "none")
            + (f"; refused: {refused}" if refused else ""))
        del q, k, v, out, want, want_probe, lib_out
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {fails}")
    return total, rows, max_err


# Faults that ``--planted-faults`` plants in copies of K4's source: (name,
# [(text replaced, its replacement), ...], whether the fault reaches a
# phase-6 shape of this Sq and window). Phase 6's check must fail at every
# shape each one reaches. A window edge moved out must move in the tile
# walk too: at decode_32k the window starts on a tile edge, so a mask
# alone would keep the extra key out. The mask faults reach every body
# because `interior_tile` decides by `sees` too: a tile a moved edge cuts
# is an edge tile, and masked.
K4_FAULTS = [
    ("one KV tile dropped", [("*j0 = static_cast<int>(k_lo / bkv);",
                              "*j0 = static_cast<int>(k_lo / bkv) + 1;")],
     lambda sq, window: True),
    ("causal edge one key in", [("(!p.causal || q_pos >= k_pos)",
                                 "(!p.causal || q_pos > k_pos)")],
     lambda sq, window: True),
    ("window edge one key in", [("(!p.has_window || q_pos - k_pos < p.window)",
                                 "(!p.has_window || q_pos - k_pos < p.window - 1)")],
     lambda sq, window: window is not None),
    ("window edge one key out", [
        ("(!p.has_window || q_pos - k_pos < p.window)",
         "(!p.has_window || q_pos - k_pos <= p.window)"),
        ("k_lo = qp_lo - p.window + 1;", "k_lo = qp_lo - p.window;")],
     lambda sq, window: window is not None),
    # The diagonal tile classified one tile off: taken as interior, so it
    # goes unmasked and rows see keys past their own. Only prefill has a
    # diagonal inside the keys (at decode the last key is the query's).
    ("edge tile taken as interior (diagonal one tile off)", [
        ("sees(p, true, qp_lo, k0 + n - 1)", "sees(p, true, qp_lo + n, k0 + n - 1)")],
     lambda sq, window: sq > 1),
    # The wgmma body's ring walks one KV tile short: the last tile is
    # never loaded nor awaited (producer and consumers agree, so nothing
    # hangs). Reaches the prefill shapes, the only ones on wgmma.
    ("wgmma: the ring one KV tile short", [
        ("const int steps = j1 - j0;  // KV tiles the block walks",
         "const int steps = j1 - j0 - 1;  // KV tiles the block walks")],
     lambda sq, window: sq > 1),
    # The stream body's combine drops warp 0's partial (warp 0 holds the
    # block's first tile, so every decode shape has one).
    ("stream: warp 0's partial dropped from the combine", [
        ("for (int w = 0; w < ST_WARPS; ++w)", "for (int w = 1; w < ST_WARPS; ++w)")],
     lambda sq, window: sq == 1),
]


# GEMM faults: (name, kernel source, the file the fault is planted in,
# edits of that file). The source and every shared header are copied into a
# directory of their own, the fault applied to its copy of the file, so
# that every include finds the copies. Phase 1's checks of the kernel
# (k1_checks for K1, k6_k8_checks for K6 / K8) must fail each fault.
GEMM_FAULTS = [
    ("K8: last split-K chunk dropped", "gemm_vsx_like", "gemm_blocked.cuh",
     [("for (int s = 0; s < splits; ++s) v += ws[s * total + i];",
       "for (int s = 0; s < splits - 1; ++s) v += ws[s * total + i];")]),
    ("K6: ring one k-step short", "gemm_packed", "gemm_wgmma.cuh",
     [("return ktiles * (bk / BOX);", "return ktiles * (bk / BOX) - 1;")]),
    ("K1: A's tensor map lda wide, not K", "gemm_packed_fused_a",
     "gemm_packed_fused_a.cu",
     [("!make_tensor_map(&ta, a, dt, M, K, box_rows, lda)",
       "!make_tensor_map(&ta, a, dt, M, lda, box_rows, lda)")]),
    ("K1: last split dropped from tc_stream's reduction", "gemm_packed_fused_a",
     "gemm_packed_fused_a.cu",
     [("return reduce_splits(wsf, splits, ep, s);",
       "return reduce_splits(wsf, splits - 1, ep, s);")]),
    ("K2: a dead segment stores nothing (tc_stream)", "gemm_grouped_packed",
     "gemm_grouped_packed.cu",
     [("if (splits == 1) p.store_zeros(g, 0, j * BOX, 16, BOX, TS_THREADS);",
       "if (splits == 0) p.store_zeros(g, 0, j * BOX, 16, BOX, TS_THREADS);")]),
    ("K2: the row at the count kept (r <= count in the epilogue)",
     "gemm_grouped_packed", "gemm_grouped_packed.cu",
     [("    if (r < count) {\n      if (scale_mode == 2) v *= scales[",
       "    if (r <= count) {\n      if (scale_mode == 2) v *= scales[")]),
    ("K2: the pair's up stream read from B's map", "gemm_grouped_packed",
     "gemm_grouped_packed.cu",
     [("return stream ? &tb2 : &tb;", "return stream ? &tb : &tb;")]),
    ("K2: last split dropped from grouped_reduce", "gemm_grouped_packed",
     "gemm_grouped_packed.cu",
     [("for (int sp = 0; sp < splits; ++sp)",
       "for (int sp = 0; sp < splits - 1; ++sp)")]),
    # Both of B's maps as wide as their row strides: past N for a row-major
    # B (columns that are never stored), past K for table.t(), where the
    # NaN past K meets A's zeros.
    ("K7: B's maps row-stride wide, not N / K", "gemm_tiled", "gemm_tiled.cu",
     [("make_tensor_map(&tb, b, dt, K, N, BOX, sbk)",
       "make_tensor_map(&tb, b, dt, K, sbk, BOX, sbk)"),
      ("make_tensor_map(&tb, b, dt, N, K, BOX, sbn)",
       "make_tensor_map(&tb, b, dt, N, sbn, BOX, sbn)")]),
    ("K7: the k-box count floored (K / 64)", "gemm_tiled", "gemm_tiled.cu",
     [("const int Kb = (K + BOX - 1) / BOX;", "const int Kb = K / BOX;")]),
    ("K7: last split dropped from tc_stream's reduction", "gemm_tiled",
     "gemm_tiled.cu",
     [("return reduce_splits(wsf, splits, ep, s);",
       "return reduce_splits(wsf, splits - 1, ep, s);")]),
]



def kq_new(r):
    """A kq_checks case on one of the quantized TMA bodies with a live row."""
    return r["body"] in ("tc_stream_q", "wgmma_q") and r.get("live", True)


# Faults that ``--planted-faults`` plants in copies of K1's and K2's sources
# (name, kernel, file, edits, which kq_checks cases it reaches by their
# attributes): the tile scale of the next k-tile, the col scale applied to
# every split's partial as well as in the reduction, int4's two nibbles of
# a byte swapped, and int4's -8 read as -7 (the range taken as the
# quantizer's [-7, 7]). kq_checks must fail each at every case it reaches.
QUANT_FAULTS = [
    ("K1: the tile scale of the next k-tile", "gemm_packed_fused_a",
     "gemm_quant.cuh",
     [("  return ep.scales[static_cast<long long>(j) * Kb + kk];",
       "  return ep.scales[static_cast<long long>(j) * Kb + min(kk + 1, Kb - 1)];")],
     lambda r: r["kernel"] == "K1" and r["gran"] == "tile" and r["kb"] > 1
     and kq_new(r)),
    ("K1: the col scale applied once per split", "gemm_packed_fused_a",
     "gemm_quant.cuh",
     [("        ws[(static_cast<long long>(sp) * ep.M + r) * ep.N + gn] = v;",
       "        ws[(static_cast<long long>(sp) * ep.M + r) * ep.N + gn] = "
       "ep.scale_mode == 2 ? v * ep.scales[j] : v;")],
     lambda r: r["kernel"] == "K1" and r["gran"] == "col" and r["splits"] > 1
     and kq_new(r)),
    ("K1: int4's high and low nibbles swapped", "gemm_packed_fused_a",
     "gemm_quant.cuh", [("NIB_LO = 0, NIB_HI = 4;", "NIB_LO = 4, NIB_HI = 0;")],
     lambda r: r["kernel"] == "K1" and r["qd"] == "int4" and kq_new(r)),
    ("K1: int4's -8 read as -7 (bf16)", "gemm_packed_fused_a", "gemm_quant.cuh",
     [("    return bsub((y & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);",
       "    const uint32_t v = bsub((y & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);\n"
       "    const __nv_bfloat162 h = __hmax2(*reinterpret_cast<const __nv_bfloat162*>"
       "(&v), __float2bfloat162_rn(-7.0f));\n"
       "    return *reinterpret_cast<const uint32_t*>(&h);")],
     lambda r: r["kernel"] == "K1" and r["qd"] == "int4"
     and r["dtype"] == "torch.bfloat16" and kq_new(r)),
    ("K2: the tile scale of the next k-tile", "gemm_grouped_packed",
     "gemm_grouped_packed.cu",
     [("    return (which ? scales2 : scales)[(static_cast<long long>(e) * Nb + j) "
       "* Kb + kk];",
       "    return (which ? scales2 : scales)[(static_cast<long long>(e) * Nb + j) "
       "* Kb + min(kk + 1, Kb - 1)];")],
     lambda r: r["kernel"] == "K2" and r["gran"] == "tile" and r["kb"] > 1
     and kq_new(r)),
    ("K2: the col scale applied once per split", "gemm_grouped_packed",
     "gemm_grouped_packed.cu",
     [("          ws[(static_cast<long long>(sp) * NB + b) * total + at] = "
       "sum[b][h][x];",
       "          ws[(static_cast<long long>(sp) * NB + b) * total + at] = "
       "p.scale_mode == 2 ? sum[b][h][x] * (b ? p.scales2 : p.scales)"
       "[static_cast<long long>(e) * p.Nb + j] : sum[b][h][x];")],
     lambda r: r["kernel"] == "K2" and r["gran"] == "col" and r["splits"] > 1
     and kq_new(r)),
]

def start_gemm_faults(build, faults=GEMM_FAULTS, prefix="fault") -> list:
    """Start one nvcc a copy of each kernel with a fault of ``faults``
    (name, kernel, target, edits; by default ``GEMM_FAULTS``): the source
    and every header copied, the fault applied to its copy of the target,
    in a directory of its own (``prefix`` tells the lists apart). Returns
    the jobs, (name, kernel, process, library, log)."""
    jobs = []
    for i, (name, kernel, target, edits) in enumerate(faults):
        out_dir = build.BUILD_DIR / "planted" / f"{kernel}_{prefix}{i}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for f in list(build.CSRC.glob("*.cuh")) + [build.CSRC / f"{kernel}.cu"]:
            text = f.read_text()
            if f.name == target:
                for old, new in edits:
                    if text.count(old) != 1:
                        raise AssertionError(f"fault '{name}': '{old}' is not "
                                             f"in {target} exactly once")
                    text = text.replace(old, new)
            (out_dir / f.name).write_text(text)
        src = out_dir / f"{kernel}.cu"
        lib, log_path = src.with_suffix(".so"), src.with_suffix(".log")
        with open(log_path, "w") as log_f:
            jobs.append((name, kernel, subprocess.Popen(
                build.nvcc_command(src, lib), stdout=log_f,
                stderr=subprocess.STDOUT), lib, log_path))
    return jobs


def planted_gemm(torch, ks, jobs) -> tuple:
    """Phase 1's GEMM edge checks against the kernels as built and the
    copies ``start_gemm_faults`` builds (``jobs``): the kernels as built
    must pass, each fault must fail. Returns (results, wrong)."""
    gp, gv, gg, gt = ks["gp"], ks["gv"], ks["gg"], ks["gt"]
    # kernel -> (entry point, argtypes, wrapper module, its loader's name)
    entry = {"gemm_vsx_like": ("matmul_vsx_like_launch", gv._ARGTYPES, gv, "_kernel"),
             "gemm_packed": ("gemm_packed_launch", gp._PACKED_ARGTYPES, gp,
                             "_packed_kernel"),
             "gemm_packed_fused_a": ("gemm_packed_fused_a_launch", gp._ARGTYPES, gp,
                                     "_kernel"),
             "gemm_grouped_packed": ("gemm_grouped_packed_launch", gg._ARGTYPES, gg,
                                     "_kernel"),
             "gemm_tiled": ("gemm_tiled_launch", gt._ARGTYPES, gt, "_kernel")}
    judge = {"gemm_vsx_like": k6_k8_checks, "gemm_packed": k6_k8_checks,
             "gemm_packed_fused_a": k1_checks, "gemm_grouped_packed": k2_checks,
             "gemm_tiled": k7_checks}
    checks_name = {k6_k8_checks: "K6 / K8", k1_checks: "K1", k2_checks: "K2 / K3",
                   k7_checks: "K7"}
    t0 = time.perf_counter()
    runs = [("as built", kernel, None) for kernel in ("gemm_packed_fused_a", "gemm_packed",
                                                      "gemm_grouped_packed", "gemm_tiled")]
    for name, kernel, proc, lib, log_path in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"fault '{name}' did not build:\n"
                               + log_path.read_text()[-4000:])
        fn = getattr(ctypes.CDLL(str(lib)), entry[kernel][0])
        fn.argtypes, fn.restype = entry[kernel][1], ctypes.c_int
        runs.append((name, kernel, fn))
    log(f"  built {len(jobs)} faulty copies of K1 / K2 / K6 / K7 / K8 "
        f"({time.perf_counter() - t0:.1f} s more after K4's)")
    as_built = {k: getattr(mod, attr) for k, (_, _, mod, attr) in entry.items()}
    results, wrong = [], []
    try:
        for name, kernel, fn in runs:
            _, _, mod, attr = entry[kernel]
            if fn is not None:
                setattr(mod, attr, lambda fn=fn: fn)
            fails, _ = judge[kernel](torch, ks, quiet=True)
            setattr(mod, attr, as_built[kernel])
            expect = "pass" if fn is None else "fail"
            ok = not fails
            checks = checks_name[judge[kernel]]
            results.append(dict(kernel=name, checks=checks, expect=expect,
                                passed=ok, failed_checks=len(fails)))
            if ok != (expect == "pass"):
                wrong.append(f"{name} ({checks} checks)")
            log(f"  phase 1 {checks} checks, {name}: "
                f"{'pass' if ok else 'FAIL'} (expected {expect}); "
                f"{len(fails)} checks failed" + (f", first {fails[:3]}" if fails else ""))
    finally:
        for k, (_, _, mod, attr) in entry.items():
            setattr(mod, attr, as_built[k])
    return results, wrong


def planted_pack(torch, ks, jobs) -> tuple:
    """k5_checks against K5 as built and each copy of ``K5_FAULTS`` that
    ``jobs`` builds: as built must pass every case; each fault must fail
    every case its reach names (``k5_reach`` of the call). Returns
    (results, wrong)."""
    pk = ks["pack"]
    t0 = time.perf_counter()
    runs = [("as built", None, None)]
    for (name, _, proc, lib, log_path), (_, _, reaches) in zip(jobs, K5_FAULTS):
        if proc.wait() != 0:
            raise RuntimeError(f"fault '{name}' did not build:\n"
                               + log_path.read_text()[-4000:])
        fn = ctypes.CDLL(str(lib)).pack_tiles_launch
        fn.argtypes, fn.restype = pk._ARGTYPES, ctypes.c_int
        runs.append((name, fn, reaches))
    log(f"  built {len(jobs)} faulty copies of K5 ({time.perf_counter() - t0:.1f} s "
        f"more after the GEMM copies)")
    as_built = pk._kernel
    results, wrong = [], []
    try:
        for name, fn, reaches in runs:
            if fn is not None:
                pk._kernel = lambda fn=fn: fn
            reach = {}
            fails, _ = k5_checks(torch, ks, quiet=True, reach=reach)
            pk._kernel = as_built
            named = [] if fn is None else [t for t, r in reach.items() if reaches(r)]
            missed = [t for t in named if t not in fails]
            ok = not fails if fn is None else bool(named) and not missed
            results.append(dict(kernel=name, checks="K5", reached=len(named),
                                failed_checks=len(fails), missed=missed, ok=ok))
            if not ok:
                wrong.append(f"{name} (K5 checks)")
            log(f"  phase 1 K5 checks, {name}: {len(fails)} of {len(reach)} cases "
                f"failed" + (f" (it reaches {len(named)}, all must fail; missed "
                             f"{missed})" if fn is not None else " (all must pass)")
                + f" {'ok' if ok else 'WRONG'}"
                + (f"; first {fails[:3]}" if fails and fn is None else ""))
    finally:
        pk._kernel = as_built
    return results, wrong



def planted_quant(torch, ks, jobs) -> tuple:
    """kq_checks and kq_served against K1 and K2 as built and each copy of
    ``QUANT_FAULTS`` that ``jobs`` builds (each copy replaces its kernel's
    entry point for the run): as built must pass every case; each fault
    must fail every case its reach names, at the edges and at the served
    shapes. Returns (results, wrong)."""
    gp, gg = ks["gp"], ks["gg"]
    entry = {"gemm_packed_fused_a": ("gemm_packed_fused_a_launch", gp._ARGTYPES,
                                     gp),
             "gemm_grouped_packed": ("gemm_grouped_packed_launch", gg._ARGTYPES,
                                     gg)}
    t0 = time.perf_counter()
    runs = [("as built", None, None, None)]
    for (name, kernel, proc, lib, log_path), fault in zip(jobs, QUANT_FAULTS):
        if proc.wait() != 0:
            raise RuntimeError(f"fault '{name}' did not build:\n"
                               + log_path.read_text()[-4000:])
        fn = getattr(ctypes.CDLL(str(lib)), entry[kernel][0])
        fn.argtypes, fn.restype = entry[kernel][1], ctypes.c_int
        runs.append((name, kernel, fn, fault[4]))
    log(f"  built {len(jobs)} faulty copies of K1 / K2's quantized bodies "
        f"({time.perf_counter() - t0:.1f} s more waiting for them)")
    as_built = {k: mod._kernel for k, (_, _, mod) in entry.items()}
    results, wrong = [], []
    try:
        for name, kernel, fn, reaches in runs:
            if fn is not None:
                entry[kernel][2]._kernel = lambda fn=fn: fn
            reach = {}
            fails, _ = kq_checks(torch, ks, quiet=True, reach=reach)
            served_fails, _ = kq_served(torch, ks, quiet=True, reach=reach)
            fails += served_fails
            if fn is not None:
                entry[kernel][2]._kernel = as_built[kernel]
            named = [] if fn is None else [t for t, r in reach.items() if reaches(r)]
            missed = [t for t in named if t not in fails]
            ok = not fails if fn is None else bool(named) and not missed
            results.append(dict(kernel=name, checks="quantized", reached=len(named),
                                failed_checks=len(fails), missed=missed, ok=ok))
            if not ok:
                wrong.append(f"{name} (quantized checks)")
            log(f"  phase 1 quantized checks, {name}: {len(fails)} of {len(reach)} "
                f"cases failed" + (f" (it reaches {len(named)}, all must fail; "
                                   f"missed {missed[:4]})" if fn is not None
                                   else " (all must pass)")
                + f" {'ok' if ok else 'WRONG'}"
                + (f"; first {fails[:3]}" if fails and fn is None else ""))
    finally:
        for k, (_, _, mod) in entry.items():
            mod._kernel = as_built[k]
    return results, wrong

def planted_quant_only(torch, build, ks) -> int:
    """``python3 chip_smoke.py --planted-faults quantized``: the quantized
    part of ``planted_faults`` alone (QUANT_FAULTS judged by kq_checks and
    kq_served). Exits 0 when the kernels as built pass everywhere and each
    fault fails at every case it reaches."""
    jobs = start_gemm_faults(build, [f[:4] for f in QUANT_FAULTS],
                             prefix="quant_fault")
    results, wrong = planted_quant(torch, ks, jobs)
    log(json.dumps({"planted_faults_quantized": results, "ok": not wrong}))
    if wrong:
        log(f"chip_smoke: the checks judged these as not expected: {wrong}")
        return 1
    return 0


def planted_faults(torch, build, fa, cfgs, shapes, ks) -> int:
    """``python3 chip_smoke.py --planted-faults``: shows that phase 6's
    check catches a wrong K4 and phase 1's a wrong K1, K2, K5, K6, K7 or
    K8. Starts one nvcc for each copy of K4's source with a fault of
    ``K4_FAULTS`` (under ``build/kernels/planted/``), for each GEMM copy of
    ``GEMM_FAULTS``, each K5 copy of ``K5_FAULTS`` and each quantized copy
    of ``QUANT_FAULTS``, all at once; then
    runs K4 as built and each faulty copy through the wrapper at A1-A6 and
    judges each output as phase 6 does, and the same for K1 / K2 / K6-K8
    (planted_gemm), K5 (planted_pack) and the quantized bodies (planted_quant).
    Exits 0 when the kernels as built
    pass everywhere and each fault fails at every shape it reaches."""
    text = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "planted"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for i, (name, edits, _) in enumerate(K4_FAULTS):
        faulty = text
        for old, new in edits:
            if faulty.count(old) != 1:
                raise AssertionError(f"fault '{name}': '{old}' is not in the "
                                     f"source exactly once")
            faulty = faulty.replace(old, new)
        src = out_dir / f"flash_attention_fault{i}.cu"
        src.write_text(faulty)
        lib, log_path = src.with_suffix(".so"), src.with_suffix(".log")
        with open(log_path, "w") as log_f:
            jobs.append((name, subprocess.Popen(
                build.nvcc_command(src, lib), stdout=log_f,
                stderr=subprocess.STDOUT), lib, log_path))
    gemm_jobs = start_gemm_faults(build)
    pack_jobs = start_gemm_faults(build, [(name, "pack", "pack.cu", edits)
                                          for name, edits, _ in K5_FAULTS],
                                  prefix="k5_fault")
    quant_jobs = start_gemm_faults(build, [f[:4] for f in QUANT_FAULTS],
                                   prefix="quant_fault")
    kernels = {"as built": fa._kernel()}
    for name, proc, lib, log_path in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"fault '{name}' did not build:\n"
                               + log_path.read_text()[-4000:])
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int
        kernels[name] = fn
    log(f"  built K4 and {len(jobs)} faulty copies in "
        f"{time.perf_counter() - t0:.1f} s ({len(gemm_jobs)} GEMM, "
        f"{len(pack_jobs)} K5 and {len(quant_jobs)} quantized copies building "
        f"beside them)")
    reach = {name: r for name, _, r in K4_FAULTS}
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    results, wrong = [], []
    as_built = fa._kernel
    try:
        for tag, cfg, b, sq, skv, window, _ in attention_shapes(cfgs, shapes):
            q, k, v = attention_inputs(torch, gen, cfg, b, sq, skv)
            want, want_probe = attention_wants(torch, fa, q, k, v, window)
            for name, fn in kernels.items():
                fa._kernel = lambda fn=fn: fn
                out = fa.flash_attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
                ok, errs = attention_verdict(torch, fa, out, q, k, v, window,
                                             want, want_probe)
                reached = name != "as built" and reach[name](sq, window)
                expect = "fail" if reached else "pass"
                results.append(dict(shape=tag, kernel=name, expect=expect,
                                    passed=ok, **errs))
                if ok != (expect == "pass"):
                    wrong.append(f"{tag} {name}")
                log(f"  {tag} {name}: {'pass' if ok else 'FAIL'} (expected "
                    f"{expect}); max_abs_err {errs['max_abs_err']:.2e}, norm "
                    f"{errs['norm_err']:.2e}; probe {errs['probe_max_abs_err']:.2e}"
                    f", norm {errs['probe_norm_err']:.2e}"
                    + (f"; failed: {errs['failed']}" if errs['failed'] else ""))
                del out
            del q, k, v, want, want_probe
            torch.cuda.empty_cache()
    finally:
        fa._kernel = as_built
    results_68, wrong_68 = planted_gemm(torch, ks, gemm_jobs)
    results_k5, wrong_k5 = planted_pack(torch, ks, pack_jobs)
    results_q, wrong_q = planted_quant(torch, ks, quant_jobs)
    log(f"  fault run {time.perf_counter() - t0:.1f} s")
    wrong_all = wrong + wrong_68 + wrong_k5 + wrong_q
    log(json.dumps({"planted_faults": results, "planted_faults_gemm": results_68,
                    "planted_faults_k5": results_k5,
                    "planted_faults_quantized": results_q, "ok": not wrong_all}))
    if wrong_all:
        log(f"chip_smoke: the checks judged these as not expected: {wrong_all}")
        return 1
    return 0


class Counters:
    """The launch counters of every kernel wrapper, by wrapper name."""

    def __init__(self, fns):
        self.fns = {fn.__name__: fn for fn in fns}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0
            for v in getattr(fn, "variants", {}):
                fn.variants[v] = 0

    def read(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}

    def variants(self) -> dict:
        """Launches by body of every wrapper that counts them (K1-K8)."""
        return {name: dict(fn.variants) for name, fn in self.fns.items()
                if hasattr(fn, "variants")}

    def only(self, **want) -> dict:
        """The counts of a run that launched ``want`` and nothing else."""
        out = {name: 0 for name in self.fns}
        out.update(want)
        return out


def graph_summary(served, cont, families) -> dict:
    """Each served path's decode graph beside its eager loop: decode
    ms/step end to end, the step alone (a replay, an eager forward), the
    device-busy share of each, the capture's ms, and whether tokens and
    launches by body were equal; phase 2b's runs and batched step; phase
    7's eight configs."""
    out = {}
    for path, t in served.items():
        g, e, check = t, t["eager"], t["graph_check"]
        out[path] = dict(
            graph_ms_per_step=g["decode_ms_per_step"],
            eager_ms_per_step=e["decode_ms_per_step"],
            graph_replay_ms=g["model_decode_ms"],
            eager_forward_ms=e["model_decode_ms"],
            graph_busy_ms=g["decode_device_busy_ms"],
            eager_busy_ms=e["decode_device_busy_ms"],
            graph_busy_share_of_replay=g["decode_device_busy_share"],
            eager_busy_share_of_forward=e["decode_device_busy_share"],
            graph_busy_share=g["generate_device_busy_share"],
            graph_busy_share_range=g["generate_device_busy_share_range"],
            eager_busy_share=e["generate_device_busy_share"],
            eager_busy_share_range=e["generate_device_busy_share_range"],
            capture_ms=check["capture_ms"], warmup_ms=check["warmup_ms"],
            tokens_bitwise_equal=check["tokens_bitwise_equal"],
            launches_equal=check["launches_equal"],
            replay_records=check["replay_records"],
            prefill_graph=t["prefill_graph"])
        if "sampled" in t:
            out[path]["sampled"] = t["sampled"]
    out["olmo-1b continuous"] = dict(
        runs={r["label"]: dict(graph_tokens_per_s=r["tokens_per_s"],
                               eager_tokens_per_s=r["eager"]["tokens_per_s"],
                               graph_ms_per_step=r["ms_per_step"],
                               eager_ms_per_step=r["eager"]["ms_per_step"],
                               capture_ms=r["capture_ms"],
                               equal_to_eager=r["equal_to_eager"],
                               replay_records=r["replay_records"],
                               prefill_graphs=r["prefill_graphs"])
              for r in cont["runs"]},
        frontend=dict(graph_tokens_per_s=cont["subset_frontend_tokens_per_s"],
                      eager_tokens_per_s=cont["subset_frontend_eager_tokens_per_s"],
                      streams_bitwise_eager=cont["frontend_graph_bitwise_eager"],
                      prefill_graphs=cont["frontend_prefill_graphs"]),
        graph_step=dict(ms=cont["batched_step_ms"],
                        host_ms=cont["batched_step_host_ms"],
                        busy_ms=cont["batched_step_device_busy_ms"],
                        busy_share=cont["device_busy_share"]),
        eager_step=cont["eager_step"],
        graph_step_equal_to_eager=cont["graph_step_equal_to_eager"])
    for arch, r in families.items():
        out[arch] = {k: r[k] for k in (
            "decode_ms_per_step", "decode_busy_share",
            "graph_decode_ms_per_step", "graph_decode_busy_share",
            "graph_capture_ms", "graph", "prefill_ms", "prefill_busy_share",
            "prefill_graph_ms", "prefill_replay_ms", "prefill_graph_busy_share",
            "prefill_capture_ms", "prefill_logits_bitwise_equal") if k in r}
        out[arch]["tokens_bitwise_equal"] = r["graph_check"].get(
            "tokens_bitwise_equal")
    return out


def forward_sum(rows, kernel, m, key, counts):
    """A per-shape column summed over one forward's calls (``counts``:
    (K, N) -> calls in the forward)."""
    return sum(r[key] * counts.get((r["k"], r["n"]), 0) for r in rows
               if r["kernel"] == kernel and r.get("m") == m)


def served_attention_ab(torch, cfgs, shapes, other_path) -> int:
    """``--served-attention PATH``: ``chunked_attention`` of the
    ``models/layers.py`` at PATH against this tree's, in turns (other,
    this, this, other), each through served_attention."""
    import importlib.util
    from repro_torch.models import layers
    spec = importlib.util.spec_from_file_location("other_layers", other_path)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    times = {"other": [], "this": []}
    for tag, fn in (("other", other.chunked_attention), ("this", layers.chunked_attention),
                    ("this", layers.chunked_attention), ("other", other.chunked_attention)):
        log(f"  {tag}: {other_path if tag == 'other' else 'this tree'}")
        rows = served_attention(torch, fn, cfgs, shapes)
        times[tag].append({r["shape"]: r["ms"] for r in rows})
    log(json.dumps({"served_attention_ab": times, "other": str(other_path)}))
    return 0


def quant_summary(quant_t, quant_seen, quant_cells, src, card) -> list:
    """The summary line's entries of the quantized TMA bodies: launched by
    this run's quantized served cells, timed by phase 1 (int8 tiles with
    tile scales the headline, int4 tiles with col scales beside it)."""
    kernels = []

    def body_launches(kernel, body):
        by_cell = {cell: t[f"{kernel}_launches_by_body"].get(body, 0)
                   for cell, t in quant_cells.items()
                   if f"{kernel}_launches_by_body" in t}
        return sum(by_cell.values()), {c: v for c, v in by_cell.items() if v}

    def quant_entry(name, source, replaces, kernel, body, times, alt, work,
                    max_err):
        total, cells = body_launches(kernel, body)
        rows = times["shapes"] if isinstance(times, dict) else times
        kernels.append(dict(
            name=name, route="cuda", source=src + source, replaces=replaces,
            launches=total, launches_by_path=cells, max_abs_err=max_err,
            ms=times["ms"], device_ms=times["device_ms"],
            old_body_device_ms=times["old_device_ms"], plain_ms=times["plain_ms"],
            bound_ms=times["bound_ms"],
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                      else "operations"),
            library_ms=times["library_ms"],
            library_device_ms=times.get("library_device_ms"),
            library=times["library"], int4_col=alt, work=work, card=card))

    def grouped_quant(fmt_key, env):
        rows = [r for r in quant_t[fmt_key] if r["envelope"] == env]
        out = {key: MIXTRAL_LAYERS * sum(r[k] for r in rows) for key, k in (
            ("ms", "k2_ms"), ("device_ms", "k2_device_ms"),
            ("old_device_ms", "k2_old_device_ms"), ("plain_ms", "k2_plain_ms"),
            ("bound_ms", "k2_bound_ms"), ("k3_device_ms", "k3_device_ms"),
            ("k3_old_device_ms", "k3_old_device_ms"),
            ("k3_bound_ms", "k3_bound_ms"))}
        out.update(library_ms=None, library_device_ms=None,
                   library="none: no single PyTorch call computes a grouped "
                           "GEMM against scaled int8 / int4 tiles",
                   shapes=[dict(r, bound_by=r["k2_bound_by"]) for r in rows])
        return out
    qerr = quant_seen["max_abs_err_by_body"]
    k1_dec, k1_pre = "olmo-1b decode forward (113 calls, M=4)", (
        "the 112 projections of an olmo-1b prefill forward (M=512)")
    quant_entry("gemm_packed_fused_a tc_stream_q", "gemm_quant.cuh",
                "src/repro/kernels/gemm_packed.py:162", "k1", "tc_stream_q",
                quant_t["K1 int8:tile decode"], quant_t["K1 int4:col decode"],
                "int8 tiles, tile scales: one " + k1_dec,
                qerr.get("gemm_packed_fused_a tc_stream_q"))
    quant_entry("gemm_packed_fused_a wgmma_q", "gemm_quant.cuh",
                "src/repro/kernels/gemm_packed.py:162", "k1", "wgmma_q",
                quant_t["K1 int8:tile prefill"], quant_t["K1 int4:col prefill"],
                "int8 tiles, tile scales: " + k1_pre,
                qerr.get("gemm_packed_fused_a wgmma_q"))
    mix_dec = (f"one decode forward of {MIXTRAL_LAYERS}-layer mixtral-8x22b "
               f"({2 * MIXTRAL_LAYERS} calls, E=8 C=8)")
    quant_entry("gemm_grouped_packed_ragged tc_stream_q", "gemm_grouped_packed.cu",
                "src/repro/kernels/gemm_grouped.py:284", "k2", "tc_stream_q",
                grouped_quant("K2 int8:tile", "decode"),
                grouped_quant("K2 int4:col", "decode"),
                "int8 tiles, tile scales: " + mix_dec,
                qerr.get("gemm_grouped_packed_ragged tc_stream_q"))
    quant_entry("gemm_grouped_packed_ragged wgmma_q", "gemm_grouped_packed.cu",
                "src/repro/kernels/gemm_grouped.py:284", "k2", "wgmma_q",
                grouped_quant("K2 int8:tile", "prefill"),
                grouped_quant("K2 int4:col", "prefill"),
                f"int8 tiles, tile scales: the {2 * MIXTRAL_LAYERS} expert calls "
                f"of a {MIXTRAL_LAYERS}-layer mixtral-8x22b prefill (E=8 C=160)",
                qerr.get("gemm_grouped_packed_ragged wgmma_q"))
    kernels[-1]["quantized_cells"] = quant_cells
    return kernels


def main(argv) -> int:
    if not (argv in ([], ["--planted-faults"], ["--planted-faults", "quantized"])
            or (len(argv) == 2 and argv[0] == "--served-attention")):
        print("usage: python3 chip_smoke.py [--planted-faults [quantized] | "
              "--served-attention OTHER/layers.py]", file=sys.stderr)
        return 2
    try:
        import torch
        from repro_torch import configs as cfgs
        from repro_torch import models, serve
        from repro_torch.core import contraction as ctr
        from repro_torch.core import gemm, health, layered, strategy
        from repro_torch.configs import shapes
        from repro_torch.core import tile_format as tf
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import gemm_grouped as gg
        from repro_torch.kernels import gemm_packed as gp
        from repro_torch.kernels import gemm_tiled as gt
        from repro_torch.kernels import gemm_vsx_like as gv
        from repro_torch.kernels import ops
        from repro_torch.kernels import pack as pk
        from repro_torch.kernels import ref
        from repro_torch.testing import faults
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
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    card = card_line()
    log(f"card: {card}")

    def at_phase(msg):
        log(f"[{time.perf_counter() - t_start:.1f} s] {msg}")
    if argv and argv[0] == "--served-attention":
        log("served attention: chunked_attention of another layers.py "
            "against this tree's, in turns")
        return served_attention_ab(torch, cfgs, shapes, argv[1])
    if argv[1:] == ["quantized"]:
        log("planted faults: K1 / K2's quantized bodies as built and with each "
            "fault of QUANT_FAULTS, judged by phase 1's quantized checks (the "
            "edges and the served shapes)")
        return planted_quant_only(torch, build, dict(gp=gp, gg=gg, ref=ref, tf=tf))
    if argv:
        log("planted faults: K4 as built and with each fault of K4_FAULTS, "
            "judged by phase 6's check at A1-A6; K1 / K2 / K6-K8 as built "
            "and with each fault of GEMM_FAULTS, K5 with each of K5_FAULTS "
            "and K1 / K2's quantized bodies with each of QUANT_FAULTS, judged "
            "by phase 1's edge checks (the quantized ones also at the served "
            "shapes)")
        return planted_faults(torch, build, fa, cfgs, shapes,
                              dict(pack=pk, gp=gp, gv=gv, gg=gg, gt=gt, ref=ref,
                                   tf=tf))
    from repro_torch.kernels import counted_wrappers
    counters = Counters(counted_wrappers())

    at_phase("phase 1: build + kernel vs plain")
    with healthy(health, "phase 1"):
        t0 = time.perf_counter()
        paths = build.build_all()
        log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dump_all_sass(paths.values())
        log(f"  SASS of every library dumped in {time.perf_counter() - t0:.1f} s")
        for name, path in paths.items():
            lines = path.with_suffix(".log").read_text().splitlines() \
                if path.with_suffix(".log").exists() else []
            for line in lines:
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        log(f"  gemm_vsx_like SASS: {check_no_tensor_cores(paths['gemm_vsx_like'])}")
        log(f"  gemm_packed SASS: {check_wgmma(paths['gemm_packed'])}")
        log(f"  gemm_packed_fused_a SASS: "
            f"{check_k1_sass(paths['gemm_packed_fused_a'])}")
        log(f"  gemm_grouped_packed SASS: "
            f"{check_grouped_sass(paths['gemm_grouped_packed'])}")
        for name, want in QUANT_SASS.items():
            log(f"  {name} quantized TMA bodies' SASS: "
                f"{check_quant_sass(paths[name], want)}")
        log(f"  gemm_tiled SASS: {check_k7_sass(paths['gemm_tiled'])}")
        log(f"  flash_attention SASS: {check_k4_sass(paths['flash_attention'])}")
        log(f"  pack SASS: {check_k5_sass(paths['pack'])}")
        SASS_CACHE.clear()
        timer_checks = [timer_check(torch, "phase 1, a fresh process")]
        table, main_err = phase_kernels(torch, gp, ref, tf, pk)
        grouped_rows, grouped_err = phase_grouped(torch, gg, ref, tf)
        quant_t, quant_seen = phase_quant_kernels(torch, dict(gp=gp, gg=gg,
                                                              ref=ref, tf=tf))
        layered_rows, layered_err = phase_layered(
            torch, dict(pack=pk, gp=gp, gt=gt, gv=gv), tf)
        attn_err = phase_attention_checks(torch, fa)
        ops_counts = phase_ops_checks(
            torch, ops, counters, dict(pack=pk, gp=gp, gt=gt, gv=gv, gg=gg,
                                       fa=fa))
    torch.cuda.empty_cache()

    at_phase("phase 2: serve full-width olmo-1b, packed weights")
    with healthy(health, "phase 2"):
        load, launches, serve_t, packed_run = phase_serve(
            torch, gp, counters, cfgs, models, serve)
    torch.cuda.empty_cache()

    at_phase("phase 2b: serve full-width olmo-1b through the continuous-batching "
             "scheduler (paged KV pool, packed weights)")
    t_phase = time.perf_counter()
    with healthy(health, "phase 2b"):
        cont_load, cont_launches, cont_t = phase_serve_continuous(
            torch, counters, serve, packed_run)
    cont_t["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"serve_continuous": cont_t, "card": card}))
    log(f"  phase 2b took {cont_t['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    at_phase(f"phase 3: serve mixtral-8x22b, {MIXTRAL_LAYERS} of 56 layers, "
             f"published widths")
    with healthy(health, "phase 3"):
        mix_load, mix_launches, mix_t, mix_logits = phase_mixtral(
            torch, gp, gg, counters, cfgs, models, serve)
    torch.cuda.empty_cache()

    quant_paths, quant_cells = {}, {}
    for quantize in OLMO_QUANT:
        at_phase(f"phase 3b: serve full-width olmo-1b, {quantize} weights "
                 f"(phase 2's values)")
        with healthy(health, f"phase 3b ({quantize})"):
            load_q, run_q, quant_cells[f"olmo-1b {quantize}"] = \
                phase_serve_quant(torch, gp, counters, serve, packed_run,
                                  quantize)
        quant_paths[f"olmo-1b {quantize}, load"] = load_q
        quant_paths[f"olmo-1b {quantize}"] = run_q
        torch.cuda.empty_cache()
    at_phase(f"phase 3c: serve mixtral-8x22b, {MIXTRAL_LAYERS} of 56 layers, "
             f"{MIXTRAL_QUANT} weights (phase 3's seed)")
    with healthy(health, "phase 3c"):
        load_q, run_q, quant_cells[f"mixtral-8x22b {MIXTRAL_QUANT}"] = \
            phase_mixtral_quant(torch, gp, gg, counters, cfgs, models, serve,
                                mix_logits)
    quant_paths[f"mixtral-8x22b {MIXTRAL_QUANT}, load"] = load_q
    quant_paths[f"mixtral-8x22b {MIXTRAL_QUANT}"] = run_q
    del mix_logits
    torch.cuda.empty_cache()

    at_phase("phase 4: the paper's strategy sweep (square GEMMs, f32 and bf16)")
    with healthy(health, "phase 4"):
        sweep_launches, sweep_rows, grouped_sweep, sweep_variants = phase_sweep(
            torch, counters, gemm, strategy, ref)
    torch.cuda.empty_cache()

    at_phase("phase 5: serve full-width olmo-1b, raw weights, Engine(model, params)")
    with healthy(health, "phase 5"):
        raw_launches, raw_t = phase_serve_raw(torch, counters, ctr, serve,
                                              packed_run)
    del packed_run
    torch.cuda.empty_cache()

    at_phase("phase 6: long-context attention through ops.attention, full head "
             "width, bf16")
    with healthy(health, "phase 6"):
        timer_checks.append(timer_check(torch, "phase 6, after the served "
                                               "profiles"))
        attn_launches, attn_rows, attn_main_err = phase_attention(
            torch, fa, ops, counters, ref, cfgs, shapes)
        from repro_torch.models import layers as model_layers
        served_attn = served_attention(torch, model_layers.chunked_attention,
                                       cfgs, shapes)
    log(json.dumps({"served_attention": served_attn, "card": card}))
    torch.cuda.empty_cache()

    at_phase("phase 7: serve the other eight configs at published widths, packed "
             "weights (" + ", ".join(FAMILY_DEPTH) + ")")
    with healthy(health, "phase 7"):
        family_paths, families, families_s = phase_families(
            torch, gp, gg, counters, cfgs, models, serve, card)
    torch.cuda.empty_cache()

    at_phase("phase 8: train full-width olmo-1b through launch.train.main (bf16 "
             "compute, f32 masters, 4 x 512 tokens a step, remat)")
    with healthy(health, "phase 8"):
        train_launched, train_res = phase_train(torch, counters, models, card)
    train_bodies = train_res["launches_by_body"]
    torch.cuda.empty_cache()

    at_phase("phase 9: guarded dispatch (no fault, every site, one fault while "
             "serving) and the serving launcher (launch.serve.main, full-width "
             "olmo-1b; the train -> checkpoint -> serve lifecycle)")
    with healthy(health, "phase 9"):
        phase_guard(torch, dict(ctr=ctr, faults=faults, health=health, gemm=gemm,
                                layered=layered, models=models, serve=serve),
                    counters, cfgs, models, serve, card)
    torch.cuda.empty_cache()

    at_phase("phase 10: the multi-device layer (sp_decode_attention under a "
             "one-rank NCCL group at olmo-1b's decode width; the train "
             "launcher with no group and under the group), in its own process")
    with healthy(health, "phase 10"):
        phase_parallel(card)

    at_phase("phase 11: train qwen3-4b, mamba2-130m, hymba-1.5b, paligemma-3b "
             "and whisper-base at published widths as jobs of "
             "repro_torch.harness on local-cuda (with a retried, a failing "
             "and a manifest job), in its own process")
    with healthy(health, "phase 11"):
        harness_res = phase_harness(card)
    harness_paths = {f"{arch} train (harness)": r["launches"]
                     for arch, r in harness_res["families"].items()}

    at_phase("phase 12: the grouped facades at mixtral-8x22b's expert widths "
             "(K2 / K3, packed and raw stacks), LayeredGemm by strategy at "
             "olmo-1b's shapes, in its own process; then the four example "
             "entry points on the card")
    with healthy(health, "phase 12"):
        surface_res = phase_surface(card)
    surface_paths = {
        "mixtral-8x22b facades, load": surface_res["facades"]["load"],
        "mixtral-8x22b facades": surface_res["facades"]["launches"],
        "LayeredGemm at olmo-1b's shapes": surface_res["layered"]["launches"]}

    def surface_bodies(kernel):
        """Phase 12's launches of ``kernel`` by body, by path."""
        out = {}
        for path, key in (("mixtral-8x22b facades", "facades"),
                          ("LayeredGemm at olmo-1b's shapes", "layered")):
            got = {v: c for v, c in
                   surface_res[key]["variants"].get(kernel, {}).items() if c}
            if got:
                out[path] = got
        return out

    def harness_bodies(kernel):
        return {f"{arch} train (harness)": r["launches_by_body"][kernel]
                for arch, r in harness_res["families"].items()}

    by_path = {"olmo-1b packed, load": load, "olmo-1b packed": launches,
               "olmo-1b continuous, load": cont_load,
               "olmo-1b continuous": cont_launches,
               "mixtral-8x22b packed, load": mix_load,
               "mixtral-8x22b packed": mix_launches,
               "strategy sweep": sweep_launches, "olmo-1b raw": raw_launches,
               "ops.attention": attn_launches, **quant_paths, **family_paths,
               "olmo-1b train": train_launched, **harness_paths,
               **surface_paths}

    def path_counts(*names):
        counted = {p: sum(c[n] for n in names) for p, c in by_path.items()}
        return sum(counted.values()), {p: v for p, v in counted.items() if v}

    # One decode forward (batch 4) of K1 calls: the per-shape times weighted
    # by each shape's count in one forward (x 16 layers; the head once).
    layers = cfgs.get_config("olmo-1b").num_layers
    count = {s: (c * layers if c else 1) for s, c in OLMO_SHAPES.items()}
    prefill_count = {s: c * layers for s, c in OLMO_SHAPES.items() if c}
    dec = [r for r in table if r["m"] == 4]
    agg = {key: sum(r[key] * count[(r["k"], r["n"])] for r in dec)
           for key in ("ms", "device_ms", "plain_ms", "library_ms",
                       "library_device_ms", "bound_ms")}
    pre = [r for r in table if r["m"] == 512 and (r["k"], r["n"]) in prefill_count]
    k1_prefill = {key: sum(r[key] * prefill_count[(r["k"], r["n"])] for r in pre)
                  for key in ("ms", "device_ms", "library_ms",
                              "library_device_ms", "bound_ms")}
    k1_prefill["work"] = ("the 112 projections of one olmo-1b prefill forward "
                          "at 4 x 128 = 512 rows (the LM head runs at 4 rows)")
    # One decode forward of the 4-layer mixtral: a gate/up pair and a down
    # projection per layer at the decode envelope (phase 1's counts).
    gdec = [r for r in grouped_rows if r["envelope"] == "decode"]

    def gsum(key):
        return MIXTRAL_LAYERS * sum(r[key] for r in gdec)

    def gby(key):
        return ("bytes" if all(r[key] == "bytes" for r in gdec)
                else "operations")

    def layered_entry(kernel, m, counts, work):
        rows = [r for r in layered_rows if r["kernel"] == kernel
                and r.get("m") == m]
        out = {key: forward_sum(layered_rows, kernel, m, key, counts)
               for key in ("ms", "plain_ms", "bound_ms")}
        if all("device_ms" in r for r in rows):
            for key in ("device_ms", "library_device_ms"):
                out[key] = forward_sum(layered_rows, kernel, m, key, counts)
            out["prefill_512"] = {key: forward_sum(layered_rows, kernel, 512, key,
                                                   counts)
                                  for key in ("ms", "device_ms", "library_ms",
                                              "library_device_ms", "bound_ms")}
        lib = [r["library_ms"] for r in rows]
        out["library_ms"] = (None if None in lib else
                             forward_sum(layered_rows, kernel, m,
                                         "library_ms", counts))
        if all("library_f32_ms" in r for r in rows):
            out["library_f32_ms"] = forward_sum(layered_rows, kernel, m,
                                                "library_f32_ms", counts)
            out["library_f32_device_ms"] = forward_sum(
                layered_rows, kernel, m, "library_f32_device_ms", counts)
            out["library_f32"] = ("torch.matmul in f32 with TF32 off (CUDA "
                                  "cores), the yardstick of a kernel kept off "
                                  "the tensor cores")
        out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                           else "operations")
        out.update(work=work, shapes=rows, card=card)
        return out

    decode_work = "one decode forward of olmo-1b, batch 4 (113 calls, M=4)"
    grouped_work = (f"one decode forward of {MIXTRAL_LAYERS}-layer "
                    f"mixtral-8x22b, batch 4 ({2 * MIXTRAL_LAYERS} calls: a "
                    f"gate/up pair and a down projection a layer, E=8 C=8)")
    library = ("torch.bmm on natural bf16 weights over the padded "
               "[E, S*C, K] A: two bmm + silu*mul for the pair, one for down")
    src = "src/repro_torch/kernels/csrc/"
    kernels = []

    def entry(name, source, replaces, counted, **fields):
        total, paths_ = path_counts(*counted)
        kernels.append(dict(name=name, route="cuda", source=src + source,
                            replaces=replaces, launches=total,
                            launches_by_path=paths_, **fields))

    entry("gemm_packed_fused_a", "gemm_packed_fused_a.cu",
          "src/repro/kernels/gemm_packed.py:162", ["gemm_packed_fused_a"],
          max_abs_err=main_err, ms=agg["ms"], plain_ms=agg["plain_ms"],
          bound_ms=agg["bound_ms"],
          bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in dec)
                    else "operations"),
          library_ms=agg["library_ms"], device_ms=agg["device_ms"],
          library_device_ms=agg["library_device_ms"], prefill_512=k1_prefill,
          quantized=quant_t,
          continuous={k: v for k, v in cont_t.items()
                      if k not in ("runs", "subset_scheduler")},
          launches_by_body={
              "olmo-1b packed": serve_t["k1_launches_by_body"],
              "olmo-1b continuous": cont_t["k1_launches_by_body"],
              "mixtral-8x22b packed": mix_t["k1_launches_by_body"],
              "strategy sweep": {v: c for v, c in
                                 sweep_variants["gemm_packed_fused_a"].items() if c},
              "olmo-1b raw": raw_t["k1_launches_by_body"],
              **{f"{arch} packed": r["k1_launches_by_body"]
                 for arch, r in families.items()},
              "olmo-1b train": train_bodies["gemm_packed_fused_a"],
              **harness_bodies("gemm_packed_fused_a")},
          families=families, families_phase_s=families_s,
          training={k: v for k, v in train_res.items() if k != "history"},
          harness_training={arch: {k: v for k, v in r.items()
                                   if k != "shape_checks"}
                            for arch, r in harness_res["families"].items()},
          work=decode_work, shapes=table, serve=serve_t, card=card)
    entry("gemm_grouped_packed_ragged", "gemm_grouped_packed.cu",
          "src/repro/kernels/gemm_grouped.py:284", ["gemm_grouped_packed_ragged"],
          max_abs_err=grouped_err, ms=gsum("k2_ms"), plain_ms=gsum("k2_plain_ms"),
          bound_ms=gsum("k2_bound_ms"), bound_by=gby("k2_bound_by"),
          library_ms=gsum("library_ms"), device_ms=gsum("k2_device_ms"),
          library_device_ms=gsum("library_device_ms"), library=library,
          launches_by_body={
              "mixtral-8x22b packed": mix_t["k2_launches_by_body"],
              "strategy sweep": {v: c for v, c in sweep_variants[
                  "gemm_grouped_packed_ragged"].items() if c},
              **{f"{arch} packed": r["k2_launches_by_body"]
                 for arch, r in families.items() if r["k2_launches_by_body"]}},
          work=grouped_work, shapes=grouped_rows, serve=mix_t, card=card)
    entry("gemm_grouped_packed", "gemm_grouped_packed.cu",
          "src/repro/kernels/gemm_grouped.py:112", ["gemm_grouped_packed"],
          max_abs_err=grouped_err, ms=gsum("k3_ms"), plain_ms=gsum("k3_plain_ms"),
          bound_ms=gsum("k3_bound_ms"), bound_by=gby("k3_bound_by"),
          library_ms=gsum("library_ms"), device_ms=gsum("k3_device_ms"),
          library_device_ms=gsum("library_device_ms"), library=library,
          launches_by_body={"strategy sweep": {v: c for v, c in sweep_variants[
              "gemm_grouped_packed"].items() if c}},
          work=grouped_work + "; every row live (no counts)", card=card)
    kernels += quant_summary(quant_t, quant_seen, quant_cells, src, card)
    k5_keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
               "general_device_ms", "bound_ms")
    k5_library = ("torch's one-call strided copy, x.reshape(Kb, bk, Nb, bn).permute(2, "
                  "0, 1, 3).contiguous(): the same function for float tiles on "
                  "tile-aligned shapes only (int4, and ragged shapes, which need "
                  "F.pad first, have no single call)")

    def nonzero(counts):
        return {v: c for v, c in counts.items() if c}
    entry("pack", "pack.cu", "src/repro/kernels/pack.py:43",
          ["pack_a", "pack_b"], max_abs_err=layered_err["pack_b"],
          **{key: forward_sum(layered_rows, "pack_b", None, key, prefill_count)
             for key in k5_keys}, bound_by="bytes", body="tma_copy",
          launches_by_body={
              "olmo-1b packed, load": serve_t["k5_load_launches_by_body"],
              "olmo-1b continuous, load": cont_t["k5_load_launches_by_body"],
              "mixtral-8x22b packed, load": mix_t["k5_load_launches_by_body"]["pack_b"],
              "strategy sweep": {name: nonzero(sweep_variants[name])
                                 for name in ("pack_a", "pack_b")},
              "olmo-1b raw": raw_t["k5_launches_by_body"],
              **{f"{arch} packed, load": r["k5_load_launches_by_body"]["pack_b"]
                 for arch, r in families.items()},
              "olmo-1b train": train_bodies["pack_b"],
              **harness_bodies("pack_b")},
          library=k5_library,
          work="the 112 per-call pack_b of one raw-weight olmo-1b prefill forward "
               "(bf16, bk 128 bn 64, row)",
          shapes=[r for r in layered_rows if r["kernel"] == "pack_b"],
          raw_prefill_profile=raw_t["prefill_profile"], card=card)
    grouped_pack = [r for r in layered_rows if r["kernel"] == "pack_b_grouped"][0]
    entry("pack_b_grouped", "pack.cu", "src/repro/kernels/pack.py:121",
          ["pack_b_grouped"], max_abs_err=layered_err["pack_b_grouped"],
          **{k: grouped_pack[k] for k in k5_keys + ("bound_by", "body")},
          launches_by_body={
              "mixtral-8x22b packed, load":
                  mix_t["k5_load_launches_by_body"]["pack_b_grouped"],
              "strategy sweep": nonzero(sweep_variants["pack_b_grouped"]),
              **{f"{arch} packed, load":
                 r["k5_load_launches_by_body"]["pack_b_grouped"]
                 for arch, r in families.items()
                 if r["k5_load_launches_by_body"]["pack_b_grouped"]}},
          library=k5_library,
          work=f"one mixtral-8x22b expert stack, E={MIX_E} x {MIX_D} x "
               f"{MIX_F} bf16", grouped_sweep=grouped_sweep, card=card)
    entry("gemm_packed", "gemm_packed.cu", "src/repro/kernels/gemm_packed.py:93",
          ["gemm_packed"], max_abs_err=layered_err["gemm_packed"],
          sweep_launches_by_body=sweep_variants["gemm_packed"],
          **layered_entry("gemm_packed", 4, count, decode_work +
                          ", A and B pre-packed"))
    entry("gemm_tiled", "gemm_tiled.cu", "src/repro/kernels/gemm_tiled.py:58",
          ["gemm_tiled"], max_abs_err=layered_err["gemm_tiled"],
          **layered_entry("gemm_tiled", 4, count, decode_work +
                          ", the LM head as table.t()"),
          launches_by_body={
              "strategy sweep": {v: c for v, c in
                                 sweep_variants["gemm_tiled"].items() if c},
              "olmo-1b raw": raw_t["k7_launches_by_body"],
              "olmo-1b train": train_bodies["gemm_tiled"],
              **harness_bodies("gemm_tiled")},
          square_4096=[r for r in layered_rows if r["kernel"] == "gemm_tiled"
                       and r.get("strategy")],
          serve=raw_t, sweep=sweep_rows)
    entry("matmul_vsx_like", "gemm_vsx_like.cu",
          "src/repro/kernels/gemm_vsx_like.py:73", ["matmul_vsx_like"],
          max_abs_err=layered_err["matmul_vsx_like"],
          sweep_launches_by_body=sweep_variants["matmul_vsx_like"],
          **layered_entry("matmul_vsx_like", 4, count, decode_work +
                          ", f32 output, CUDA cores only"))
    entry("matmul_vsx_like_packed", "gemm_vsx_like.cu",
          "src/repro/kernels/gemm_vsx_like.py:108", ["matmul_vsx_like_packed"],
          on_main_path=False, max_abs_err=layered_err["matmul_vsx_like_packed"],
          **layered_entry("matmul_vsx_like_packed", 4, count, decode_work +
                          ", B pre-packed, f32 output, CUDA cores only"))

    def attn_sum(key):
        vals = [r[key] for r in attn_rows]
        return None if None in vals else sum(vals)
    by_ops = sum(r["bound_ms"] for r in attn_rows if r["bound_by"] == "operations")
    entry("flash_attention", "flash_attention.cu",
          "src/repro/kernels/flash_attention.py:73", ["flash_attention"],
          on_main_path=("reached through repro_torch.kernels.ops.attention "
                        "(phase 6), not by the served models"),
          max_abs_err=attn_main_err, checks_max_abs_err=attn_err,
          ms=attn_sum("ms"), device_ms=attn_sum("device_ms"),
          plain_ms=attn_sum("plain_ms"), bound_ms=attn_sum("bound_ms"),
          bound_by="operations" if 2 * by_ops > attn_sum("bound_ms") else "bytes",
          library_ms=attn_sum("library_ms"),
          library_device_ms=attn_sum("library_device_ms"),
          profiler_device_ms=attn_sum("profiler_ms"),
          profiler_lost={r["tag"]: r["profiler_lost"] for r in attn_rows
                         if r["profiler_lost"]}, timer_checks=timer_checks,
          device_fallbacks=DEVICE_FALLBACKS,
          launches_by_body={r["tag"]: r["body"] for r in attn_rows},
          library="F.scaled_dot_product_attention(enable_gqa=True), backend "
                  "per shape",
          work="one ops.attention call at each of A1-A6 (bf16), summed",
          shapes=attn_rows, ops_launches=ops_counts, card=card)
    for k in kernels:
        names = ("pack_a", "pack_b") if k["name"] == "pack" else (k["name"],)
        bodies = {n: surface_bodies(n) for n in names if surface_bodies(n)}
        if bodies:
            k["phase12_launches_by_body"] = (bodies if k["name"] == "pack"
                                             else bodies[k["name"]])
    log(json.dumps({"graphs": graph_summary(
        {"olmo-1b packed": serve_t, "mixtral-8x22b packed": mix_t,
         **quant_cells, "olmo-1b raw": raw_t}, cont_t, families), "card": card}))
    # Every credited launch count above was held to the kernel records of
    # the replays it credits (else the run stopped there).
    log(json.dumps({"replay_launch_checks": REPLAY_CHECKS, "card": card}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:  # any phase failing fails the run, with its traceback
        traceback.print_exc()
        sys.exit(1)
