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
  * ``kernel_run:1`` raising at the warm-up, naming the spec, then a
    clean warm-up and a clean capture on the next two calls;
  * the prefill's graphs (one per prompt shape: the first call eager, the
    second the capture, then replays) bitwise the eager prefill's, logits
    and caches, with the same launches by body, at two prompt lengths, on
    the packed, raw and int8 paths; a fault at the prefill's warm-up;
  * ``StreamFrontend`` on the prefill graphs and the width-1 decode graph
    bitwise its eager streams;
  * a real failure: K1's source broken so that it does not build, which
    must raise ``BuildError`` naming the source and the spec, eagerly and
    inside a prefill capture, with nothing recorded or served otherwise.

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
                               Request, ServeConfig, StreamConfig,
                               StreamFrontend, VirtualClock, graphs)
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
    engine keeps one graph: the first call's first step warms it up, its
    second captures it, every other step replays it."""
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
    is recorded. The next call warms up again and the one after captures,
    their logits bitwise the eager decode's, and so are a replay's."""
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
    assert step.graph is None and torch.equal(got, want)
    got = step(inputs)["logits"].clone()
    assert step.graph is not None and torch.equal(got, want)
    assert torch.equal(step(inputs)["logits"], want) and step.replays == 2


def test_kernel_run_in_generate_warm_up_then_the_first_tokens():
    """Armed at the first hit past the prefill's (one per projection and
    the LM head), ``kernel_run`` fails ``generate`` at the decode graph's
    warm-up; the next ``generate`` warms up again, captures at its second
    step and gives the eager tokens."""
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


# ---------------------------------------------------------------------------
# The prefill's graphs and the front end's batch-1 decode graph
# ---------------------------------------------------------------------------

def _prefill_eager(engine, batch):
    engine._graphed = False
    try:
        logits, caches = engine._prefill(batch)
        return logits.clone(), graphs.clone(caches)
    finally:
        engine._graphed = True


def _same_tree(a, b) -> bool:
    la, lb = list(graphs._leaves(a)), list(graphs._leaves(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("path", ["olmo-packed", "olmo-raw", "olmo-int8"])
def test_prefill_graph_is_bitwise_the_eager_prefill(path):
    """At two prompt lengths, each a graph of its own: the first call is
    the eager warm-up, the second captures (and replays), the third
    replays; every call's logits and caches bitwise the eager prefill's,
    and a replay's launches by body (credited) equal an eager prefill's.
    Both graphs write the static caches of the one decode graph of their
    width."""
    engine = _engine(path)
    for length in (PROMPT[1], PROMPT[1] + 8):
        gen = torch.Generator().manual_seed(10 + length)
        batch = {"tokens": torch.randint(0, 512, (PROMPT[0], length),
                                         generator=gen).cuda()}
        want_logits, want_caches = _prefill_eager(engine, batch)
        _reset_counts()
        engine._prefill(batch)
        eager = _counts()
        for call in range(3):
            _reset_counts()
            logits, caches = engine._graphed_prefill(batch)
            torch.cuda.synchronize()
            counted = _counts()
            step = engine._prefill_graphs[graphs.signature(batch)]
            assert (step.graph is not None) == (call > 0), call
            assert step.replays == call
            assert torch.equal(logits, want_logits), (length, call)
            assert _same_tree(caches, want_caches), (length, call)
            assert counted == eager, (length, call)
    assert len(engine._prefill_graphs) == 2 and len(engine._graphs) == 1
    (decode,) = engine._graphs.values()
    assert all(g.static["caches"] is decode.static["caches"]
               for g in engine._prefill_graphs.values())
    assert {id(g.pool) for g in engine._prefill_graphs.values()} == \
        {id(engine._graph_pool)}
    assert not health.HEALTH


def test_kernel_run_at_the_prefill_warm_up_raises_then_captures_clean():
    """``kernel_run:1`` at a prefill graph's first call raises in the eager
    warm-up, naming the spec; nothing is recorded and nothing is served.
    The next call warms up clean, the one after captures, and both give
    the eager prefill's logits bitwise."""
    engine = _engine()
    batch = {"tokens": _prompt(11).cuda()}
    want_logits, _ = _prefill_eager(engine, batch)
    with faults.inject("kernel_run", nth=1):
        with pytest.raises(faults.InjectedFault) as info:
            engine._graphed_prefill(batch)
    notes = "\n".join(getattr(info.value, "__notes__", []))
    assert "packed_weight" in notes and "dense[" in notes
    assert not health.HEALTH
    step = engine._prefill_graphs[graphs.signature(batch)]
    assert step.graph is None and step.replays == 0
    for call in range(2):
        logits, _ = engine._graphed_prefill(batch)
        assert torch.equal(logits, want_logits), call
    assert step.graph is not None and step.replays == 1


def _stream_tokens(engine, graphed, n=6):
    engine._graphed = graphed
    clock = VirtualClock()
    fe = StreamFrontend(engine, StreamConfig(queue_capacity=8, max_live=3),
                        clock=clock, sleep=clock.sleep)
    try:
        _reset_counts()
        for r in _requests(n, seed=4):
            fe.submit(r)
        fe.drain()
        torch.cuda.synchronize()
    finally:
        engine._graphed = True
    health.clear_serve()
    return ({rid: (r.status, r.tokens.tolist()) for rid, r in fe.results.items()},
            _counts())


def test_frontend_streams_on_the_graphs_are_bitwise_eager():
    """``StreamFrontend`` through the prefill graphs and the batch-1 decode
    graph gives its eager streams bitwise, with the same launches by body;
    one width-1 decode graph serves every request."""
    engine = _engine()
    got, counted = _stream_tokens(engine, True)
    want, eager = _stream_tokens(engine, False)
    assert got == want and counted == eager
    assert all(status == "completed" for status, _ in got.values())
    (decode,) = engine._graphs.values()
    assert decode.replays > 0 and decode.static["tok"].shape == (1, 1)
    again, _ = _stream_tokens(engine, True)
    assert again == want


def test_prefill_graphs_keep_no_device_memory_once_their_engine_goes():
    """Prefill graphs of three prompt lengths (each warmed up, captured and
    replayed) and the width-1 decode graph keep no device memory once
    their engine is freed: every graph warms up and captures on the one
    capture stream, so no stream of theirs keeps a cuBLAS workspace."""
    import gc

    def serve_lengths():
        engine = _engine()
        for length in (8, 12, 16):
            for _ in range(3):
                engine.prefill_request(torch.arange(length) % 512)
        _, caches = engine.prefill_request(torch.arange(8))
        engine.decode_request(caches, torch.tensor([[3]]), 8)
        assert sum(g.replays for g in engine._prefill_graphs.values()) == 7
        torch.cuda.synchronize()
    serve_lengths()          # the capture stream's own first use
    gc.collect()
    before = torch.cuda.memory_allocated()
    serve_lengths()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# A real failure on the card: a kernel whose source does not build
# ---------------------------------------------------------------------------

@pytest.fixture
def broken_k1(monkeypatch, tmp_path):
    """A switch that points the kernel build at a copy of K1's source that
    does not compile (its own source and build directories), with K1's
    loaded library forgotten, and back."""
    from repro_torch.kernels import build
    from repro_torch.kernels import gemm_packed as gp
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = build.CSRC / "gemm_packed_fused_a.cu"
    (csrc / src.name).write_text("#error this copy of K1 does not build\n"
                                 + src.read_text())
    real = (build.CSRC, build.BUILD_DIR, build._LIBS)

    def switch(broken: bool):
        build.CSRC, build.BUILD_DIR, build._LIBS = (
            (csrc, tmp_path / "build", {}) if broken else real)
        gp._kernel.cache_clear()
    yield switch
    switch(False)


def test_a_kernel_that_does_not_build_raises_naming_spec_and_source(broken_k1):
    """K1's source, broken, fails its build: the prefill raises
    ``BuildError`` naming the source, with the note that names the spec
    and the lowering; nothing is recorded and no other lowering serves.
    Inside a prefill capture the same failure raises the same way and no
    graph is kept; with the source mended, the next call captures and
    gives the eager prefill's logits bitwise."""
    from repro_torch.kernels.build import BuildError
    engine = _engine()
    batch = {"tokens": _prompt(12).cuda()}
    want_logits, _ = _prefill_eager(engine, batch)
    for where in ("eager", "capture"):
        if where == "capture":
            engine._graphed_prefill(batch)       # the warm-up, built clean
        broken_k1(True)
        with pytest.raises(BuildError) as info:
            if where == "eager":
                engine._prefill(batch)
            else:
                engine._graphed_prefill(batch)
        broken_k1(False)
        notes = "\n".join(getattr(info.value, "__notes__", []))
        assert "gemm_packed_fused_a" in str(info.value), where
        assert "does not build" in str(info.value), where
        assert "packed_weight" in notes and "dense[" in notes, where
        assert not health.HEALTH, where
    step = engine._prefill_graphs[graphs.signature(batch)]
    assert step.graph is None and step.replays == 0
    logits, _ = engine._graphed_prefill(batch)
    assert step.graph is not None and torch.equal(logits, want_logits)
    assert not health.HEALTH
