"""The captured serving steps on the card against the eager ones, without
JAX (the machine with the card has none; ``tests/test_torch_graphs.py``
holds the graph's step body to the JAX package on the CPU).

On the card ``Engine.generate`` replays one CUDA graph per batch width and
cache layout, and ``ContinuousScheduler`` its batched step's graph
(``repro_torch.serve.graphs``); the private ``_graphed = False`` runs the
eager loop they are compared with. A narrow olmo-1b-shaped decoder and a
narrow mixtral-8x22b (2 layers, d_model 256, heads of 64, d_ff 512, vocab
512), bf16, so that every projection and the LM head run on K1 (packed and
int8), K7 (raw) or, for the experts, K2:

  * greedy tokens of the graph bitwise the eager loop's, two prompts at
    one width each so (stale static inputs would show), a new width on a
    graph of its own;
  * launches by body (``.variants``) after the replays equal to the eager
    steps';
  * the scheduler's batched step, its bisection and its preempt / resume
    bitwise the eager step's;
  * ``kernel_run:1`` raising at the warm-up, naming the spec, and a clean
    capture on the next call.

Every test is ``cuda``: it skips without a card.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch import kernels
from repro_torch.core import health
from repro_torch.models import build
from repro_torch.serve import (ContinuousConfig, ContinuousScheduler, Engine,
                               Request, ServeConfig, VirtualClock, graphs)
from repro_torch.testing import faults

pytestmark = pytest.mark.cuda

PROMPT = (4, 16)
STEPS = 8
PATHS = {"olmo-packed": ("olmo-1b", dict(pack_weights=True)),
         "olmo-raw": ("olmo-1b", {}),
         "olmo-int8": ("olmo-1b", dict(pack_weights=True, quantize="int8")),
         "mixtral-packed": ("mixtral-8x22b", dict(pack_weights=True))}


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    faults.reset()
    health.clear_health()
    health.clear_serve()
    yield
    faults.reset()
    health.clear_serve()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _engine(path="olmo-packed", **serve):
    arch, kw = PATHS[path]
    cfg = dataclasses.replace(
        reduced_config(arch), d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512, compute_dtype="bfloat16")
    model = build(cfg, device="cuda")
    params = _cast(model.init(0), torch.bfloat16)
    return Engine(model, params, ServeConfig(max_len=64, cache_dtype="bfloat16",
                                             **kw, **serve), device="cuda")


def _prompt(seed, rows=PROMPT[0]):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (rows, PROMPT[1]), generator=gen)


def _counts():
    return {fn.__name__: (fn.launches, dict(fn.variants))
            for fn in kernels.counted_wrappers()}


def _reset_counts():
    for fn in kernels.counted_wrappers():
        fn.launches = 0
        for body in fn.variants:
            fn.variants[body] = 0


def _generate(engine, prompt, graphed):
    engine._graphed = graphed
    try:
        _reset_counts()
        out = engine.generate({"tokens": prompt}, STEPS)
        return out, _counts()
    finally:
        engine._graphed = True


@pytest.mark.parametrize("path", list(PATHS))
def test_graph_tokens_and_launches_equal_eager(path):
    """The graph's greedy tokens are bitwise the eager loop's; after the
    replays the wrappers' launches by body equal the eager steps'; the
    engine keeps one graph: the first call's first step captures it, every
    other step replays it."""
    engine = _engine(path)
    assert engine._graphed
    prompt = _prompt(1)
    got, counted = _generate(engine, prompt, True)
    want, eager = _generate(engine, prompt, False)
    np.testing.assert_array_equal(got, want)
    assert counted == eager
    assert sum(n for n, _ in eager.values()) > 0
    again, counted = _generate(engine, prompt, True)
    np.testing.assert_array_equal(again, want)
    assert counted == eager
    (step,) = engine._graphs.values()
    assert step.graph is not None and step.replays == 2 * STEPS - 1
    assert not health.HEALTH


def test_two_prompts_at_one_width_each_equal_eager():
    """Two prompts at the same width through one graph, each bitwise the
    eager loop's: the static caches and tokens are refilled per call."""
    engine = _engine()
    a, b = _prompt(2), _prompt(3)
    got = [_generate(engine, p, True)[0] for p in (a, b, a)]
    assert len(engine._graphs) == 1
    for p, g in zip((a, b, a), got):
        np.testing.assert_array_equal(g, _generate(engine, p, False)[0])
    assert not np.array_equal(got[0], got[1])


def test_a_new_batch_width_gets_its_own_graph():
    """A second width captures a graph of its own into the engine's one
    memory pool; the first width's graph, replayed after it, still gives
    the eager tokens."""
    engine = _engine()
    four, two = _prompt(4), _prompt(5, rows=2)
    got4 = _generate(engine, four, True)[0]
    got2 = _generate(engine, two, True)[0]
    assert len(engine._graphs) == 2
    assert {id(s.pool) for s in engine._graphs.values()} == {id(engine._graph_pool)}
    again4 = _generate(engine, four, True)[0]
    want4 = _generate(engine, four, False)[0]
    np.testing.assert_array_equal(got4, want4)
    np.testing.assert_array_equal(again4, want4)
    np.testing.assert_array_equal(got2, _generate(engine, two, False)[0])


def test_sampled_decode_on_the_graph_logits_equals_eager():
    engine = _engine(temperature=0.8, seed=5)
    prompt = _prompt(6)
    np.testing.assert_array_equal(_generate(engine, prompt, True)[0],
                                  _generate(engine, prompt, False)[0])


# ---------------------------------------------------------------------------
# The scheduler's batched step
# ---------------------------------------------------------------------------

def _requests(n=8, seed=1):
    r = np.random.default_rng(seed)
    return [Request(request_id=i,
                    tokens=r.integers(0, 512, int(r.choice((8, 16, 24))))
                    .astype(np.int32),
                    max_new_tokens=int(r.choice((6, 10, 16))))
            for i in range(n)]


def _serve(engine, graphed, fault=None, **kw):
    clock = VirtualClock()
    cs = ContinuousScheduler(engine, ContinuousConfig(
        queue_capacity=32, max_live=4, block_size=8, max_retries=1, **kw),
        clock=clock, sleep=clock.sleep)
    cs._graphed = graphed
    _reset_counts()
    armed = (faults.inject("batch_step", nth=fault) if fault
             else contextlib.nullcontext())
    with armed:
        for r in _requests():
            cs.submit(r)
        cs.drain(max_ticks=20_000)
    s = cs.stats()
    assert s["offered"] == s["admitted"] == 8
    assert cs.kv.alloc.free_count == cs.kv.alloc.capacity
    health.clear_serve()
    return cs, s, {rid: (r.status, r.tokens.tolist())
                   for rid, r in cs.results.items()}, _counts()


@pytest.mark.parametrize("kw,fault", [
    ({}, None), ({"num_kv_blocks": 10}, None), ({}, (1, 2, 3)),
    ({"kv_quantize": "int8"}, None)],
    ids=["unpressured", "preempt-resume", "bisection", "int8-pool"])
def test_scheduler_graph_is_bitwise_the_eager_step(kw, fault):
    """Every request's status and tokens through the captured step equal
    the eager step's (preempt / resume under a small pool, bisection after
    a poisoned shared step, the int8 pool), with the same launches by
    body."""
    engine = _engine()
    cs, s, graphed, counted = _serve(engine, True, fault, **kw)
    assert cs._step_graph is not None and cs._step_graph.graph is not None
    assert cs._step_graph.replays > 0
    _, s_eager, eager, eager_counts = _serve(engine, False, fault, **kw)
    assert graphed == eager and s == s_eager
    assert counted == eager_counts
    if "num_kv_blocks" in kw:
        assert s["preempted"] >= 1 and s["resumed"] == s["preempted"]
    if fault:
        assert s["evicted"] == 1


def test_scheduler_rows_alone_are_bitwise_the_batched_rows():
    """Through the graph, a row of the batched step equals the same row
    run alone (the other rows dead): the single-row path of bisection and
    resume replays the same graph."""
    engine = _engine()
    clock = VirtualClock()
    cs = ContinuousScheduler(engine, ContinuousConfig(max_live=4, block_size=8),
                             clock=clock, sleep=clock.sleep)
    for r in _requests(4):
        cs.submit(r)
    cs.step()
    cs.step()
    assert len(cs._live) == 4 and cs._step_graph.graph is not None
    tokens = np.zeros((4, 1), np.int64)
    pos = np.zeros((4,), np.int64)
    for row, slot in cs._live.items():
        tokens[row, 0] = slot.emitted[-1]
        pos[row] = slot.req.tokens.shape[0] + len(slot.emitted) - 1
    logits = cs._step(cs.kv.device_tables(), tokens, pos)[0].clone()
    for row in cs._live:
        alone = cs._row_step(row, int(tokens[row, 0]), int(pos[row]))[0]
        assert torch.equal(alone[row], logits[row]), row
    cs._graphed = False
    eager = cs._step(cs.kv.device_tables(), tokens, pos)[0]
    assert torch.equal(eager, logits)


# ---------------------------------------------------------------------------
# A fault at the warm-up
# ---------------------------------------------------------------------------

def test_kernel_run_at_warm_up_raises_then_captures_clean():
    """``kernel_run:1`` at the decode graph's first call raises in the
    warm-up, naming the spec and the lowering; no graph is kept and nothing
    is recorded. The next call captures, its logits bitwise the eager
    decode's, and so are a replay's."""
    engine = _engine()
    _, caches = engine._prefill({"tokens": _prompt(7).cuda()})
    b = PROMPT[0]
    tok = torch.randint(0, 512, (b, 1), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(8))
    inputs = {"caches": caches, "tok": tok, "pos": PROMPT[1]}
    step = engine._decode_graph(caches, b)
    with faults.inject("kernel_run", nth=1):
        with pytest.raises(faults.InjectedFault) as info:
            step(inputs)
    notes = "\n".join(getattr(info.value, "__notes__", []))
    assert "packed_weight" in notes and "dense[" in notes
    assert step.graph is None and not health.HEALTH

    def eager():
        clone = graphs.static_like(caches)
        graphs.copy_in(clone, caches)
        pos = torch.full((b,), PROMPT[1], dtype=torch.long, device="cuda")
        return engine._decode(clone, tok, pos)[0][:, 0]
    want = eager()
    got = step(inputs)["logits"].clone()
    assert step.graph is not None and torch.equal(got, want)
    assert torch.equal(step(inputs)["logits"], want) and step.replays == 1


def test_kernel_run_in_generate_warm_up_then_the_first_tokens():
    """Armed at the first hit past the prefill's (one per projection and
    the LM head), ``kernel_run`` fails ``generate`` at the decode graph's
    warm-up; the next ``generate`` captures and gives the eager tokens."""
    engine = _engine()
    prompt = _prompt(9)
    hits = 7 * engine.model.cfg.num_layers + 1
    with faults.inject("kernel_run", nth=hits + 1):
        with pytest.raises(faults.InjectedFault):
            engine.generate({"tokens": prompt}, STEPS)
        assert faults.hits("kernel_run") == hits + 1
    (step,) = engine._graphs.values()
    assert step.graph is None
    got = _generate(engine, prompt, True)[0]
    np.testing.assert_array_equal(got, _generate(engine, prompt, False)[0])
