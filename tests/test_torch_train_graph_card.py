"""The captured train step and the sampler's graph on the card against
their eager forms, without JAX (the machine with the card has none;
``tests/test_torch_train_graph.py`` and ``tests/test_torch_sampler.py``
hold the same functions to the JAX package and to numpy on the CPU).

  * every config's reduced train step (``launch.train.preset_config(arch,
    "tiny")``, f32, its contractions on the card's kernels, mixtral's
    experts on ``grouped_einsum``) captured by ``make_train_step``: the
    warm-up, the capture and three replays bitwise five eager functional
    steps from the same init and batches (params, moments, step, metrics),
    the static leaves at their addresses, and the launches by body of the
    graphed steps (replays credited) equal to the eager steps';
  * ``kernel_run:1`` at the train warm-up raising, naming the spec, the
    static tree left as it was; then a clean warm-up and a clean capture;
  * the sampler's graph captured and replayed bitwise its eager draw; the
    card's uniforms bitwise the CPU's, its draws equal to the CPU's on 4096
    fixed rows (a row whose two best perturbed scores lie within 1e-5 may
    differ: such rows are counted and printed); ties to the first maximal
    index at olmo-1b's vocabulary.

Every test is ``cuda``: it skips without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, reduced_config
from repro_torch.core import health
from repro_torch.data.pipeline import DataConfig, MarkovLM
from repro_torch.launch.train import device_batch, preset_config
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig, sampler
from repro_torch.testing import faults
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainConfig, make_train_step

pytestmark = pytest.mark.cuda

BATCH, SEQ = 4, 64
CALLS = 5          # the warm-up, the capture (and its replay), 3 more replays


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    faults.reset()
    health.clear_health()
    yield
    faults.reset()
    assert not health.HEALTH


def _counts():
    return {fn.__name__: (fn.launches, dict(fn.variants))
            for fn in kernels.counted_wrappers()}


def _reset_counts():
    for fn in kernels.counted_wrappers():
        fn.launches = 0
        for body in fn.variants:
            fn.variants[body] = 0


def _batches(cfg, n):
    """``n`` Markov batches on the card, with ``patches`` / ``frames`` of
    N(0, 1) where the family takes them."""
    data = MarkovLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH))
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for i in range(n):
        batch = device_batch(data.batch_at(i), "cuda")
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (BATCH, cfg.num_patches, cfg.d_model), generator=gen,
                device="cuda")
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn(
                (BATCH, cfg.encoder_seq, cfg.d_model), generator=gen,
                device="cuda")
        out.append(batch)
    return out


def _setup(arch):
    cfg = preset_config(arch, "tiny")
    model = build(cfg, device="cuda")
    step = make_train_step(model, TrainConfig(optim=opt.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=CALLS)))
    return cfg, model, step


def _assert_bitwise(got, want):
    for x, y in zip(opt.tree_leaves(got), opt.tree_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_graph_replays_are_bitwise_the_eager_steps(arch):
    cfg, model, step = _setup(arch)
    batches = _batches(cfg, CALLS)
    p = model.init(0)
    s = opt.init_state(p)
    ptrs = [t.data_ptr() for t in opt.tree_leaves((p, s))]
    _reset_counts()
    metrics = []
    for b in batches:
        p, s, m = step(p, s, b)
        metrics.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize()
    graphed = _counts()
    assert step.graph.graph is not None and step.graph.replays == CALLS - 1
    assert [t.data_ptr() for t in opt.tree_leaves((p, s))] == ptrs
    ep = model.init(0)
    es = opt.init_state(ep)
    _reset_counts()
    for b, m in zip(batches, metrics):
        ep, es, em = step._eager(ep, es, b)
        for k in m:
            assert torch.equal(m[k], em[k]), k
    torch.cuda.synchronize()
    assert _counts() == graphed
    _assert_bitwise({"p": p, "s": s}, {"p": ep, "s": es})
    assert int(s["step"]) == CALLS
    assert all(torch.isfinite(m["loss"]) for m in metrics)


def test_kernel_run_at_the_train_warm_up_raises_then_captures_clean():
    """``kernel_run:1`` at the first call raises in the eager warm-up,
    naming the spec; the static tree is as it was and nothing is recorded.
    The next call warms up again, the one after captures; both, and a
    replay, bitwise the eager steps."""
    cfg, model, step = _setup("olmo-1b")
    batches = _batches(cfg, 3)
    p = model.init(0)
    s = opt.init_state(p)
    init = opt.tree_map(torch.clone, {"p": p, "s": s})
    with faults.inject("kernel_run", nth=1):
        with pytest.raises(faults.InjectedFault) as info:
            step(p, s, batches[0])
    notes = "\n".join(getattr(info.value, "__notes__", []))
    assert "dense[" in notes, notes
    assert step.graph.graph is None and not health.HEALTH
    _assert_bitwise({"p": p, "s": s}, init)
    ep, es = init["p"], init["s"]
    for i, b in enumerate(batches):
        p, s, m = step(p, s, b)
        ep, es, em = step._eager(ep, es, b)
        assert (step.graph.graph is not None) == (i >= 1)
        assert torch.equal(m["loss"], em["loss"])
    _assert_bitwise({"p": p, "s": s}, {"p": ep, "s": es})
    assert step.graph.replays == 2


def _engine(temperature=0.7):
    cfg = dataclasses.replace(
        reduced_config("olmo-1b"), d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512, compute_dtype="bfloat16")
    model = build(cfg, device="cuda")
    return Engine(model, model.init(0), ServeConfig(
        max_len=64, temperature=temperature, seed=3), device="cuda")


def test_sampler_graph_replays_are_bitwise_its_eager_draw():
    """Three calls at one logits shape: the warm-up, the capture and a
    replay, each bitwise the eager draw; another shape has a graph of its
    own; the returned tokens are the caller's (a later replay leaves them)."""
    engine = _engine()
    gen = torch.Generator(device="cuda").manual_seed(4)
    kept = []
    for i in range(3):
        logits = torch.randn((4, 50304), generator=gen, device="cuda") * 3
        got = engine.sample_tokens(logits, [3, 1, 4, 1], [i, i, i, 5])
        engine._graphed = False
        want = engine.sample_tokens(logits, [3, 1, 4, 1], [i, i, i, 5])
        engine._graphed = True
        assert got.dtype == torch.int32 and torch.equal(got, want)
        kept.append((got, want))
    (graph,) = engine._sample_graphs.values()
    assert graph.graph is not None and graph.replays == 2
    one = torch.randn((1, 50304), generator=gen, device="cuda")
    engine.sample_tokens(one, [2], 0)
    assert len(engine._sample_graphs) == 2
    assert all(torch.equal(g, w) for g, w in kept)


def test_card_draws_equal_the_cpu_draws():
    """4096 fixed rows of 2048 logits (and 16 of 50304): the card's
    uniforms bitwise the CPU's, its noise within one f32 ulp of the CPU's,
    its tokens the CPU's but where a row's two best perturbed scores lie
    within 1e-5 (counted and printed)."""
    rng = np.random.default_rng(11)
    near, differ = 0, []
    for rows, width, temp in ((4096, 2048, 0.7), (16, 50304, 1.3)):
        logits = (rng.standard_normal((rows, width)) * 2).astype(np.float32)
        keys = sampler.row_keys(17, np.arange(rows), np.arange(rows) % 5)
        for lo in range(0, rows, 512):
            lg, ky = logits[lo:lo + 512], keys[lo:lo + 512]
            u_cpu = sampler.uniforms(torch.from_numpy(ky), width)
            u_card = sampler.uniforms(torch.from_numpy(ky).cuda(), width)
            assert torch.equal(u_card.cpu(), u_cpu)
            g_cpu = sampler.gumbel(torch.from_numpy(ky), width)
            g_card = sampler.gumbel(torch.from_numpy(ky).cuda(), width).cpu()
            ulp = torch.abs(torch.nextafter(g_cpu, torch.full_like(g_cpu, 1e30))
                            - g_cpu)
            assert bool((torch.abs(g_card - g_cpu) <= ulp).all())
            cpu = sampler.draw(torch.from_numpy(lg), torch.from_numpy(ky), temp)
            card = sampler.draw(torch.from_numpy(lg).cuda(),
                                torch.from_numpy(ky).cuda(), temp).cpu()
            scores = (torch.from_numpy(lg) * float(np.float32(1 / temp))
                      + g_cpu)
            top2 = torch.topk(scores, 2, dim=-1).values
            close = (top2[:, 0] - top2[:, 1]) <= 1e-5
            near += int(close.sum())
            for r in torch.nonzero(cpu != card).flatten().tolist():
                differ.append((lo + r, bool(close[r])))
    print(f"rows within 1e-5 of a tie: {near}; rows that differ: {differ}")
    assert all(close for _, close in differ), differ


def test_ties_go_to_the_first_maximal_index_on_the_card():
    x = torch.zeros((6, 50304), device="cuda")
    firsts = [0, 1, 4097, 25000, 50302, 50303]
    for r, c in enumerate(firsts):
        x[r, c:] = 1.0 if r % 2 else 0.0
        x[r, c] = 2.0
        x[r, -1] = 2.0
    assert torch.argmax(x, dim=-1).tolist() == firsts
