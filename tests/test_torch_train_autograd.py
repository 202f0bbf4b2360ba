"""Training of the port without JAX: the gradient of a kernel contraction
(``core.autograd.KernelContraction``), the refusal of packed and grouped
kernel contractions that need a gradient, the checkpoint module (the
reference's ten checkpoint tests), packed tiles never outliving a step,
and the train launcher run and resumed on the CPU.

The file imports no JAX, so its ``cuda`` cases run on the card's machine:
the Function against the ``torch_matmul`` lowering's autograd at olmo-1b's
shapes and at M off a tile, each product held to the body it must take.
Tolerances: f32 on the CPU 1e-5 relative Frobenius error (the plain
versions accumulate in f32 in another order); bf16 on the card 2e-2.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import autograd as tag
from repro_torch.core import gemm
from repro_torch.core import strategy as tstrat
from repro_torch.core.contraction import ContractionSpec
from repro_torch.core.epilogue import EPILOGUE_SPECS, EpilogueSpec
from repro_torch.core.layered import GroupedPackedWeight, PackedWeight
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.testing import faults
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.optimizer import AdamWConfig

torch.set_num_threads(1)

KERNEL_STRATEGIES = [s for s in tstrat.STRATEGIES if s != "torch_matmul"]
EPILOGUES = {"none": (False, "none"), "bias": (True, "none"),
             "silu": (False, "silu"), "gelu_tanh": (True, "gelu")}
_ENV = "REPRO_TORCH_GEMM_STRATEGY"


def _rel_fro(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _operands(m, k, n, bias, device="cpu", dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=gen).to(device, dtype).requires_grad_()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(device, dtype)
    w.requires_grad_()
    b = (torch.randn(n, generator=gen).to(device, dtype).requires_grad_()
         if bias else None)
    dy = torch.randn(m, n, generator=gen).to(device, dtype)
    return a, w, b, dy


def _grads(strategy, a, w, b, dy, activation):
    out = gemm.linear(a, w, b, strategy=strategy,
                      epilogue=EpilogueSpec(activation=activation))
    leaves = [a, w] + ([b] if b is not None else [])
    return out.detach(), torch.autograd.grad(out, leaves, dy)


# ---------------------------------------------------------------------------
# The Function on the CPU (the kernels' plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epi", list(EPILOGUES))
@pytest.mark.parametrize("strategy", KERNEL_STRATEGIES)
def test_kernel_gradients_match_torch_matmul(strategy, epi):
    """dX, dW and dbias through each kernel strategy named explicitly (the
    plain versions on CPU tensors) against the ``torch_matmul``
    lowering's autograd; the forward values too."""
    bias, act = EPILOGUES[epi]
    a, w, b, dy = _operands(70, 45, 33, bias)
    out, got = _grads(strategy, a, w, b, dy, act)
    out0, want = _grads("torch_matmul", a, w, b, dy, act)
    assert _rel_fro(out, out0) < 1e-5
    for g, w_ in zip(got, want):
        assert _rel_fro(g, w_) < 1e-5, (strategy, epi)


def test_kernel_contraction_with_c_alpha_beta():
    """The matmul facade's ``alpha * A @ B + beta * C`` with every operand
    needing a gradient, through K1's and K7's lowerings."""
    gen = torch.Generator().manual_seed(1)
    ops = [torch.randn(s, generator=gen).requires_grad_()
           for s in ((40, 24), (24, 18), (40, 18), (18,))]
    dy = torch.randn(40, 18, generator=gen)

    def run(strategy):
        a, b, c, bias = ops
        out = gemm.matmul(a, b, c, alpha=0.7, beta=-1.3, bias=bias,
                          epilogue="silu", strategy=strategy)
        return torch.autograd.grad(out, ops, dy)
    want = run("torch_matmul")
    for strategy in ("tiling_packing_fused", "tiling"):
        for g, w in zip(run(strategy), want):
            assert _rel_fro(g, w) < 1e-5, strategy


@pytest.mark.parametrize("strategy", [None, "tiling"])
def test_dw_operand_follows_the_pick(strategy, monkeypatch):
    """dW = A^T @ g with the dispatch forced onto the card's pick: where it
    is K1 (``tiling_packing_fused``), which refuses a transposed A, A^T is
    copied contiguous; on a named ``tiling`` (K7 reads any strides) it
    stays the view. Both give A^T @ g."""
    monkeypatch.setenv(_ENV, "tiling_packing_fused")
    a, w, b, dy = _operands(96, 64, 80, False, seed=2)
    want = a.detach().t() @ dy
    at, name = tag.dw_strategy(a.detach(), dy, strategy)
    assert name == (strategy or "tiling_packing_fused")
    assert at.stride(1) == (a.shape[1] if strategy == "tiling" else 1)
    got = tag.weight_grad(a.detach(), dy, strategy=strategy)
    assert _rel_fro(got, want) < 1e-5


def test_gelu_gradient_is_the_tanh_form():
    """The Function's gelu derivative is the tanh approximation's (the
    reference's ``jax.nn.gelu(approximate=True)``), not torch's erf form."""
    z = torch.linspace(-4, 4, 101, dtype=torch.float64)
    got = tag._act_grad("gelu", z, torch.ones_like(z))
    c = (2 / np.pi) ** 0.5
    u = c * (z + 0.044715 * z ** 3)
    want = (0.5 * (1 + torch.tanh(u)) + 0.5 * z * (1 - torch.tanh(u) ** 2)
            * c * (1 + 3 * 0.044715 * z ** 2))
    assert float((got - want).abs().max()) < 1e-12
    erf = torch.func.grad(lambda x: torch.nn.functional.gelu(x).sum())(z)
    assert float((got - erf).abs().max()) > 1e-4


def test_no_grad_calls_bypass_the_function():
    """Without a gradient the lowering runs as before (no Function node)."""
    a, w, _, _ = _operands(70, 45, 33, False)
    with torch.no_grad():
        out = gemm.linear(a, w, strategy="tiling_packing_fused")
    assert out.grad_fn is None
    out = gemm.linear(a, w, strategy="tiling_packing_fused")
    node = out.grad_fn.next_functions[0][0]   # under the reshape's view
    assert type(node).__name__.startswith("KernelContractionBackward")


# ---------------------------------------------------------------------------
# Packed and grouped kernel contractions refuse a gradient
# ---------------------------------------------------------------------------

def test_packed_weight_contraction_needing_a_gradient_raises():
    a, w, _, _ = _operands(70, 64, 64, False)
    packed = PackedWeight.pack(w.detach())
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        gemm.linear(a, packed)
    with torch.no_grad():
        gemm.linear(a, packed)   # serving, no gradient: runs


@pytest.mark.parametrize("strategy", ["grouped_packed", "grouped_packed_ragged",
                                      "packed_stack"])
def test_grouped_contraction_needing_a_gradient_raises(strategy):
    gen = torch.Generator().manual_seed(3)
    e, m, k, n = 4, 16, 32, 48
    x = torch.randn(e, m, k, generator=gen).requires_grad_()
    w = torch.randn(e, k, n, generator=gen)
    counts = torch.full((e, 1), m, dtype=torch.int32)
    if strategy == "packed_stack":
        wt, strategy, ragged = GroupedPackedWeight.pack(w), "auto", False
    else:
        wt, ragged = w, strategy == "grouped_packed_ragged"
    spec = ContractionSpec.grouped(e, m, k, n, x.dtype, w=wt, counts=ragged,
                                   epilogue=EPILOGUE_SPECS["none"])
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        gemm.contract(spec, x, wt, counts=counts if ragged else None,
                      strategy=strategy)


def test_grouped_einsum_differentiates_on_the_cpu():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 8, 16, generator=gen).requires_grad_()
    w = torch.randn(3, 16, 12, generator=gen).requires_grad_()
    spec = ContractionSpec.grouped(3, 8, 16, 12, x.dtype, w=w)
    out = gemm.contract(spec, x, w, strategy="grouped_einsum")
    gx, gw = torch.autograd.grad(out.sum(), [x, w])
    assert torch.allclose(gx, torch.ones(3, 8, 12) @ w.detach().transpose(1, 2))
    assert torch.allclose(gw, x.detach().transpose(1, 2) @ torch.ones(3, 8, 12))


# ---------------------------------------------------------------------------
# The train step through the kernel lowerings: no stale packed tiles
# ---------------------------------------------------------------------------

def _tiny(vocab=64):
    cfg = dataclasses.replace(tconfigs.reduced_config("olmo-1b"),
                              compute_dtype="float32", vocab_size=vocab)
    return cfg, build(cfg, device="cpu")


def _port_batch(batch):
    return {k: torch.as_tensor(v).long() for k, v in batch.items()}


def test_kernel_train_steps_track_torch_matmul(monkeypatch):
    """Three train steps with every contraction on K5 + K1's path
    (``tiling_packing_fused``, B packed per call) against the same steps
    on ``torch_matmul``: each step's loss within 1e-5, so the packed
    tiles of step i never serve step i + 1's weights."""
    cfg, model = _tiny()
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=4))
    step = make_train_step(model, TrainConfig(optim=AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=10)))
    losses = {}
    for strategy in ("tiling_packing_fused", "torch_matmul"):
        monkeypatch.setenv(_ENV, strategy)
        params = model.init(0)
        state = opt.init_state(params)
        losses[strategy] = []
        for i in range(3):
            params, state, m = step(params, state, _port_batch(data.batch_at(i)))
            losses[strategy].append(float(m["loss"]))
    np.testing.assert_allclose(losses["tiling_packing_fused"],
                               losses["torch_matmul"], rtol=1e-5)
    assert losses["torch_matmul"][2] != losses["torch_matmul"][0]


# ---------------------------------------------------------------------------
# Checkpoints (the reference's tests/test_checkpoint.py, in the port)
# ---------------------------------------------------------------------------

def _setup():
    cfg, model = _tiny()
    params = model.init(0)
    step = make_train_step(model, TrainConfig(
        optim=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4))
    return model, params, step, data


def _assert_trees_equal(a, b):
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip_bitwise(tmp_path):
    model, params, _, _ = _setup()
    state = {"params": params, "opt": opt.init_state(params)}
    ckpt.save(str(tmp_path), 7, state)
    template = opt.tree_map(torch.zeros_like, state)
    restored, step_no = ckpt.restore(str(tmp_path), template)
    assert step_no == 7
    _assert_trees_equal(state, restored)


def test_crash_resume_is_bitwise_identical_to_uninterrupted(tmp_path):
    """Six steps straight against three, a checkpoint, a restore into
    fresh trees and three more: the same weights, bit for bit. The step
    updates the trees it adopted at its first call in place (``params0``
    among them), so the straight run's weights are copied and the second
    run starts from a fresh init of the same seed."""
    model, params0, step, data = _setup()
    p, s = params0, opt.init_state(params0)
    for i in range(6):
        p, s, _ = step(p, s, _port_batch(data.batch_at(i)))
    straight = opt.tree_map(torch.clone, p)

    p = model.init(0)
    s = opt.init_state(p)
    for i in range(3):
        p, s, _ = step(p, s, _port_batch(data.batch_at(i)))
    ckpt.save(str(tmp_path), 3, {"params": p, "opt": s})
    del p, s
    restored, start = ckpt.restore(
        str(tmp_path), {"params": model.init(5),
                        "opt": opt.init_state(params0)})
    p, s = restored["params"], restored["opt"]
    assert start == 3
    for i in range(start, 6):
        p, s, _ = step(p, s, _port_batch(data.batch_at(i)))
    _assert_trees_equal(straight, p)


def test_corrupted_checkpoint_falls_back_to_previous(tmp_path):
    _, params, _, _ = _setup()
    state = {"params": params}
    ckpt.save(str(tmp_path), 1, state)
    ckpt.save(str(tmp_path), 2, state)
    with open(os.path.join(tmp_path, "step_2.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00" * 64)
    assert ckpt.latest_valid_step(str(tmp_path)) == 1
    _, step_no = ckpt.restore(str(tmp_path), state)
    assert step_no == 1


def test_restore_rejects_shape_mismatch(tmp_path):
    _, params, _, _ = _setup()
    ckpt.save(str(tmp_path), 1, {"params": params})
    bad = opt.tree_map(lambda x: torch.zeros(x.shape + (1,), dtype=x.dtype),
                       params)
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"params": bad})


def test_cleanup_keeps_latest(tmp_path):
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"p": torch.zeros(3)})
    ckpt.cleanup(str(tmp_path), keep_last=2)
    assert ckpt.available_steps(str(tmp_path)) == [4, 5]


def test_manifest_contains_hash(tmp_path):
    ckpt.save(str(tmp_path), 1, {"p": torch.zeros(3)})
    with open(os.path.join(tmp_path, "step_1.json")) as f:
        manifest = json.load(f)
    assert len(manifest["sha256"]) == 64
    assert manifest["leaves"] == ["p"]


def test_kill_before_publish_leaves_previous_checkpoint(tmp_path):
    """A crash with both files staged and nothing published: no trace of
    the new step, no temp litter, the previous step stays the latest."""
    state = {"p": torch.arange(6.0)}
    ckpt.save(str(tmp_path), 1, state)
    with faults.inject("checkpoint_save", nth=1):
        with pytest.raises(OSError):
            ckpt.save(str(tmp_path), 2, state)
    assert ckpt.latest_valid_step(str(tmp_path)) == 1
    assert not os.path.exists(os.path.join(tmp_path, "step_2.npz"))
    assert not any(n.startswith(".tmp_") for n in os.listdir(tmp_path))
    restored, step_no = ckpt.restore(str(tmp_path), state)
    assert step_no == 1
    assert torch.equal(restored["p"], state["p"])


def test_kill_between_publishes_keeps_step_invisible(tmp_path):
    """A crash with the npz published and the manifest (the commit point)
    not: the step never becomes valid, restore falls back, and a retried
    save of the same step commits."""
    state = {"p": torch.arange(6.0)}
    ckpt.save(str(tmp_path), 1, state)
    with faults.inject("checkpoint_save", nth=2):
        with pytest.raises(OSError):
            ckpt.save(str(tmp_path), 2, state)
    assert os.path.exists(os.path.join(tmp_path, "step_2.npz"))
    assert not os.path.exists(os.path.join(tmp_path, "step_2.json"))
    assert ckpt.latest_valid_step(str(tmp_path)) == 1
    _, step_no = ckpt.restore(str(tmp_path), state)
    assert step_no == 1
    ckpt.save(str(tmp_path), 2, state)
    assert ckpt.latest_valid_step(str(tmp_path)) == 2


def test_restore_retries_transient_read(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "RESTORE_BACKOFF_S", 0.001)
    state = {"p": torch.arange(4.0)}
    ckpt.save(str(tmp_path), 3, state)
    with faults.inject("checkpoint_read", nth=1):
        restored, step_no = ckpt.restore(str(tmp_path), state)
        assert faults.hits("checkpoint_read") >= 2
    assert step_no == 3
    assert torch.equal(restored["p"], state["p"])


def test_restore_raises_after_retries_exhausted(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "RESTORE_BACKOFF_S", 0.001)
    state = {"p": torch.arange(4.0)}
    ckpt.save(str(tmp_path), 3, state)
    with faults.inject("checkpoint_read"):
        with pytest.raises(OSError):
            ckpt.restore(str(tmp_path), state)
        assert faults.hits("checkpoint_read") == ckpt.RESTORE_RETRIES


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``launch.train.main`` on the CPU: a 5-step run checkpoints at step 3
    and at its end and writes its metrics; with step 5's files removed (a
    crash after step 3's checkpoint) a second run resumes from step 3 and
    writes a step-5 checkpoint bitwise equal to the straight run's."""
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "m.json")
    args = ["--device", "cpu", "--preset", "tiny", "--batch", "4", "--seq",
            "16", "--log-every", "1", "--steps", "5", "--ckpt-every", "3",
            "--ckpt-dir", ck]
    assert launch_train.main(args + ["--metrics-out", out]) == 0
    history = json.load(open(out))
    assert [h["step"] for h in history] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert ckpt.available_steps(ck) == [3, 5]
    straight = dict(np.load(os.path.join(ck, "step_5.npz")))
    for suffix in (".npz", ".json"):
        os.remove(os.path.join(ck, f"step_5{suffix}"))
    capsys.readouterr()
    assert launch_train.main(args) == 0
    assert "resumed from checkpoint step 3" in capsys.readouterr().out
    resumed = np.load(os.path.join(ck, "step_5.npz"))
    assert sorted(resumed.files) == sorted(straight)
    for name, arr in straight.items():
        assert resumed[name].tobytes() == arr.tobytes(), name


def test_launcher_refuses_model_parallel():
    """--model-parallel runs over the torch.distributed world: without a
    group of a multiple of its ranks the launcher refuses it (the sharded
    run over two gloo ranks is tests/test_torch_parallel.py's)."""
    with pytest.raises(ValueError, match="initialised torch.distributed "
                                         "group"):
        launch_train.main(["--device", "cpu", "--model-parallel", "2",
                           "--steps", "1"])


def test_launcher_full_preset_is_the_published_config():
    cfg = launch_train.preset_config("olmo-1b", "full")
    assert cfg == tconfigs.get_config("olmo-1b")
    tiny = launch_train.preset_config("olmo-1b", "tiny")
    assert (tiny.d_model, tiny.num_layers, tiny.vocab_size) == (128, 4, 512)


@pytest.mark.parametrize("remat", [True, False])
def test_chip_smoke_train_counts_at_full_width(remat, monkeypatch):
    """Phase 8's derived launches of one full-width olmo-1b step at 4 x 512
    tokens: 7 contractions a layer, each a forward (twice under remat), a
    dX and a dW, plus the head's three, every one K5 + K1 on ``wgmma``; K5
    stages the transposed views (the head's ``table.t()``, each layer
    weight's W^T in dX)."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    cfg = launch_train.preset_config("olmo-1b", "full")
    n = 7 * cfg.num_layers * (4 if remat else 3) + 3
    staged = 7 * cfg.num_layers + 1
    assert chip_smoke.train_step_counts(cfg, 4 * 512, remat=remat) == {
        "gemm_packed_fused_a": {"wgmma": n},
        "pack_b": {"tma_copy": n - staged, "tma_stage": staged},
        "gemm_tiled": {}}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (M, K, N): olmo-1b's projections at a 4 x 512 train batch, and M off a
# 64-row tile
CARD_SHAPES = [(2048, 2048, 2048), (2048, 2048, 8192), (2048, 8192, 2048),
               (200, 2048, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("epi", list(EPILOGUES))
@pytest.mark.parametrize("strategy", ["auto", "tiling"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_gradients_match_torch_matmul(shape, strategy, epi):
    """bf16 on the card: forward, dX, dW and dbias through the kernels
    against the ``torch_matmul`` lowering's autograd, 2e-2 relative
    Frobenius error. ``auto`` (the planner's pick at these rows): K5 + K1
    on ``wgmma`` for all three products, dW's X^T copied contiguous;
    ``tiling`` named: K7 on ``wgmma`` for the forward and dX (W^T read as
    it lies) and on ``mma_general`` for dW over the transposed view."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from repro_torch.kernels import gemm_packed as gp
    from repro_torch.kernels import gemm_tiled as gt
    from repro_torch.kernels import pack as pk
    m, k, n = shape
    bias, act = EPILOGUES[epi]
    a, w, b, dy = _operands(m, k, n, bias, "cuda", torch.bfloat16)
    out0, want = _grads("torch_matmul", a, w, b, dy, act)
    for fn in (gp.gemm_packed_fused_a, gt.gemm_tiled, pk.pack_b):
        fn.launches = 0
        for v in fn.variants:
            fn.variants[v] = 0
    out, got = _grads(strategy, a, w, b, dy, act)
    torch.cuda.synchronize()
    assert _rel_fro(out, out0) < 2e-2
    for g, w_ in zip(got, want):
        assert _rel_fro(g, w_) < 2e-2
    k1 = {v: c for v, c in gp.gemm_packed_fused_a.variants.items() if c}
    k7 = {v: c for v, c in gt.gemm_tiled.variants.items() if c}
    if strategy == "auto":
        assert k1 == {"wgmma": 3} and k7 == {}
        assert pk.pack_b.launches == 3
    else:
        assert k1 == {} and k7 == {"wgmma": 2, "mma_general": 1}
        assert pk.pack_b.launches == 0


# dW's (K, N) of a full-width olmo-1b step (the layers' with their counts
# in one step, and the head's) at 4 x 512 tokens
DW_SHAPES = {(2048, 2048): 64, (2048, 8192): 32, (8192, 2048): 16,
             (2048, 50304): 1}


@pytest.mark.cuda
def test_cuda_dw_copy_route_beats_k7_on_the_view():
    """The dW route ``core.autograd`` takes on K1's pick: X^T copied
    contiguous, then K5 + K1 (``weight_grad``), against K7 (``tiling``)
    reading the transposed view, summed over one full-width olmo-1b step's
    dW products by CUDA events (one warm call, then the mean of 3). Prints
    both sums and the per-shape ms; the copy route must be the faster."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    routes = {"copy": lambda x, g: tag.weight_grad(x, g),
              "tiling": lambda x, g: gemm.matmul(x.t(), g, strategy="tiling")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = dict.fromkeys(routes, 0.0)
    for (k, n), count in DW_SHAPES.items():
        x = torch.randn((2048, k), generator=gen, device="cuda").bfloat16()
        g = torch.randn((2048, n), generator=gen, device="cuda").bfloat16()
        for route, fn in routes.items():
            fn(x, g)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(3):
                fn(x, g)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / 3
            total[route] += count * ms
            print(f"dW {route} {k}x{n}: {ms:.4f} ms x {count}")
    print("dW a step (ms): " + ", ".join(f"{r} {t:.2f}" for r, t in total.items()))
    assert total["copy"] < total["tiling"]
