"""The captured serving step (``repro_torch.serve.graphs``) on the CPU.

On the card the engine's decode and the scheduler's batched step replay
CUDA graphs; the function captured there is ``StepGraph``'s body: the
inputs copied into the static tree, the model's decode, the functional
leaves copied back, and the greedy argmax. Here the same body runs
uncaptured (``Engine._graphed = True`` on the CPU) and is held to the JAX
reference on reduced configs in f32, the weights made with numpy and
scaled by 4 so that greedy decoding wanders: every step's logits within
1e-4 of the reference's logit scale (the tolerance of
``tests/test_torch_families.py``: the same f32 products in other summation
orders), greedy tokens equal to the reference ``Engine.generate``'s.
mamba2-130m's state is a functional leaf (copied back), whisper-base
carries the cross K / V in the static tree.

Without a card: the launch credit of a capture through a stub graph, the
numerics guard under a patched ``torch.cuda.is_current_stream_capturing``,
and the scheduler's graph body against its eager step, bitwise.
"""
import contextlib
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import build as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch import configs as tconfigs
from repro_torch.core import contraction as ctr
from repro_torch.core import health
from repro_torch.core.contraction import LOWERINGS, ContractionSpec
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.serve import (ContinuousConfig, ContinuousScheduler, Engine,
                               Request, ServeConfig, VirtualClock, graphs)
from repro_torch.testing import faults
from torch_serve_helpers import requests

torch.set_num_threads(1)

PROMPT = (2, 6)
STEPS = 6
CASES = [("olmo-1b", True), ("olmo-1b", False), ("mixtral-8x22b", True),
         ("mamba2-130m", True), ("mamba2-130m", False),
         ("whisper-base", True), ("whisper-base", False)]


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    faults.reset()
    health.clear_health()
    health.clear_serve()
    yield
    faults.reset()
    health.clear_health()
    health.clear_serve()


def _engines(arch, pack, max_len=32):
    rcfg = dataclasses.replace(rconfigs.reduced_config(arch),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch),
                               compute_dtype="float32")
    tree = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                        ref_build(rcfg).init(jax.random.PRNGKey(0)))
    ref = RefEngine(ref_build(rcfg), jax.tree.map(jnp.asarray, tree),
                    RefServeConfig(max_len=max_len, pack_weights=pack))
    port = Engine(build(tcfg, device="cpu"), params_from_numpy(tree, tcfg, "cpu"),
                  ServeConfig(max_len=max_len, pack_weights=pack), device="cpu")
    return ref, port, tcfg


def _batch(cfg, seed, rows=PROMPT[0]):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (rows, PROMPT[1])).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("arch,pack", CASES,
                         ids=[f"{a}-{'packed' if p else 'raw'}"
                              for a, p in CASES])
def test_graph_body_matches_the_reference(arch, pack):
    """The graph's step body, run uncaptured: each decode step's logits
    within 1e-4 of the reference's logit scale, its argmax the reference's
    greedy token; then ``generate`` through the body gives the reference
    ``Engine.generate``'s tokens and the eager loop's, and keeps one graph
    for the layout."""
    ref, port, cfg = _engines(arch, pack)
    batch = _batch(cfg, seed=1)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    port_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    port_batch["tokens"] = port_batch["tokens"].long()
    lr, cr = ref._prefill(ref.params, ref_batch)
    lp, caches = port._prefill(port_batch)
    _close(lp.numpy(), lr)
    tok = torch.argmax(lp, -1).to(torch.int32)[:, None]
    step = port._decode_graph(caches, PROMPT[0])
    assert step.capture is False
    for i in range(STEPS):
        rtok = jnp.argmax(lr, -1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        lr, cr = ref._decode(ref.params, cr, rtok,
                             jnp.full((PROMPT[0],), PROMPT[1] + i, jnp.int32))
        lr = lr[:, 0]
        res = step({"caches": caches, "tok": tok, "pos": PROMPT[1] + i}
                   if i == 0 else {"tok": tok, "pos": PROMPT[1] + i})
        _close(res["logits"].numpy(), lr)
        tok = res["next"].clone()
    want = np.asarray(ref.generate(ref_batch, STEPS))
    port._graphs.clear()
    port._graphed = True
    got = port.generate(batch, STEPS)
    np.testing.assert_array_equal(got, want)
    port._graphed = False
    np.testing.assert_array_equal(port.generate(batch, STEPS), got)
    assert len(port._graphs) == 1


def test_graph_per_batch_width_and_fresh_inputs_each_call():
    """Two prompts at one width share one graph, each giving the eager
    loop's tokens (the static caches and token are refilled per call); a
    new width gets a graph of its own."""
    _, port, cfg = _engines("olmo-1b", True)
    port._graphed = True
    a, b = _batch(cfg, seed=2), _batch(cfg, seed=3)
    got = [port.generate(x, STEPS) for x in (a, b)]
    assert len(port._graphs) == 1
    three = _batch(cfg, seed=4, rows=3)
    got.append(port.generate(three, STEPS))
    assert len(port._graphs) == 2
    port._graphed = False
    for x, g in zip((a, b, three), got):
        np.testing.assert_array_equal(port.generate(x, STEPS), g)
    assert not np.array_equal(got[0], got[1])


def test_sampled_decode_draws_from_the_graph_logits():
    """temperature > 0: each step's draw runs the sampler's graph body (one
    graph for the batch's logits shape, apart from the decode graph) over
    the decode graph's logits, keyed by (seed, request, step): the eager
    loop's tokens, which draw eagerly from the eager decode's logits."""
    _, port, cfg = _engines("olmo-1b", True)
    port.cfg = dataclasses.replace(port.cfg, temperature=0.8, seed=5)
    batch = _batch(cfg, seed=6)
    port._graphed = True
    got = port.generate(batch, STEPS)
    (draw,) = port._sample_graphs.values()
    assert draw.capture is False
    assert draw.static["logits"].shape == (PROMPT[0], cfg.vocab_size)
    port._graphed = False
    np.testing.assert_array_equal(port.generate(batch, STEPS), got)
    greedy = dataclasses.replace(port.cfg, temperature=0.0)
    port.cfg = greedy
    assert not np.array_equal(port.generate(batch, STEPS), got)


# ---------------------------------------------------------------------------
# The scheduler's batched step through its graph body
# ---------------------------------------------------------------------------

def _serve(engine, graphed, fault=None, **kw):
    clock = VirtualClock()
    cs = ContinuousScheduler(engine, ContinuousConfig(
        queue_capacity=32, max_live=3, block_size=8, max_retries=1, **kw),
        clock=clock, sleep=clock.sleep)
    cs._graphed = graphed
    reqs = requests(Request, 8, seed=1)
    with (faults.inject("batch_step", nth=fault) if fault
          else contextlib.nullcontext()):
        for r in reqs:
            cs.submit(r)
        cs.drain(max_ticks=20_000)
    health.clear_serve()
    return cs, {rid: (res.status, res.tokens.tolist())
                for rid, res in cs.results.items()}


@pytest.mark.parametrize("kw,fault", [
    ({}, None), ({"num_kv_blocks": 3}, None), ({}, (1, 2, 3)),
    ({"kv_quantize": "int8"}, None)],
    ids=["unpressured", "preempt-resume", "bisection", "int8-pool"])
def test_scheduler_graph_body_is_bitwise_the_eager_step(kw, fault):
    """The scheduler's step through its graph body (static tables, tokens,
    positions; the scatter outside) gives the eager step's results, token
    for token, with preemption, bisection and the int8 pool."""
    _, port, _ = _engines("olmo-1b", True)
    cs, graphed = _serve(port, True, fault, **kw)
    assert cs._step_graph is not None and cs._step_graph.capture is False
    _, eager = _serve(port, False, fault, **kw)
    assert graphed == eager
    if fault:
        assert sum(s == "evicted" for s, _ in eager.values()) == 1


def test_graphs_hold_no_reference_back_to_their_owner():
    """An engine and a scheduler that built their graphs are freed as soon
    as their last reference goes, with no garbage collection: the graphs'
    bodies hold the model, the weights and the pool, not their owner (a
    cycle would keep the weights alive, and let a collection destroy a
    graph in the middle of another's capture)."""
    _, port, cfg = _engines("olmo-1b", True)
    port._graphed = True
    port.generate(_batch(cfg, seed=2), 2)
    cs, _ = _serve(port, True)
    assert port._graphs and cs._step_graph is not None
    refs = (weakref.ref(port), weakref.ref(cs))
    collecting = gc.isenabled()
    gc.disable()
    try:
        del port, cs
        assert [r() for r in refs] == [None, None]
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_generate_frees_the_prefill_caches_before_the_decode(monkeypatch, arch):
    """One copy of the cache is alive through the decode: the caches the
    prefill graph's first call (the warm-up) makes are copied into the
    decode graph's static caches and freed before the first decode step,
    and its body writes the static caches themselves."""
    _, port, cfg = _engines(arch, True)
    port._graphed = True
    prefill, refs, alive = port.model.prefill, [], []

    def spy(params, batch, **kw):
        logits, caches = prefill(params, batch, **kw)
        refs.extend(weakref.ref(t) for t in graphs._leaves(caches))
        return logits, caches
    port.model = dataclasses.replace(port.model, prefill=spy)
    call = graphs.StepGraph.__call__

    def counted(self, inputs):
        if "tok" in inputs:   # a decode step
            static = {id(t) for t in graphs._leaves(self.static["caches"])}
            alive.append(sum(r() is not None and id(r()) not in static
                             for r in refs))
        return call(self, inputs)
    monkeypatch.setattr(graphs.StepGraph, "__call__", counted)
    for _ in range(2):
        port.generate(_batch(cfg, seed=2), 3)
    assert len(port._prefill_graphs) == 1
    (decode,) = port._graphs.values()
    static = list(graphs._leaves(decode.static["caches"]))
    # The second prefill returned the static caches' own tensors.
    assert len(refs) == 2 * len(static)
    assert all(r() is t for r, t in zip(refs[len(static):], static))
    assert refs and alive == [0] * 6


# ---------------------------------------------------------------------------
# Launch counts under replay, through a stub graph
# ---------------------------------------------------------------------------

_LAUNCHING = ("gemm_packed", "gemm_grouped", "pack", "gemm_tiled",
              "gemm_vsx_like", "flash_attention")


@pytest.mark.parametrize("module", _LAUNCHING)
def test_every_counting_wrapper_is_in_the_registry(module):
    """Each function of a kernel module that counts its launches is in
    ``kernels.counted_wrappers()``, the one list that the graphs' launch
    credit reads: a counting wrapper left out would never be credited."""
    import importlib

    from repro_torch import kernels
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    counting = {fn for fn in vars(mod).values()
                if callable(fn) and hasattr(fn, "launches")
                and getattr(fn, "__module__", None) == mod.__name__}
    registered = {fn for fn in kernels.counted_wrappers()
                  if fn.__module__ == mod.__name__}
    assert counting and counting == registered
    for fn in counting:
        assert set(fn.variants) and all(isinstance(v, int)
                                        for v in fn.variants.values())


def test_counts_launches_zeroes_and_registers_once():
    from repro_torch import kernels

    def wrapper():
        pass
    before = len(kernels.counted_wrappers())
    try:
        assert kernels.counts_launches(wrapper, ("a", "b")) is wrapper
        wrapper.launches, wrapper.variants["a"] = 3, 3
        kernels.counts_launches(wrapper, ("a", "b"))
        assert (wrapper.launches, wrapper.variants) == (0, {"a": 0, "b": 0})
        assert kernels.counted_wrappers().count(wrapper) == 1
        assert len(kernels.counted_wrappers()) == before + 1
    finally:
        kernels._COUNTED.pop(f"{wrapper.__module__}.{wrapper.__qualname__}")
    assert len(kernels.counted_wrappers()) == before

def _stub_wrappers():
    def k1():
        pass

    def k5():
        pass
    k1.launches, k1.variants = 0, {"tc_stream": 0, "wgmma": 0}
    k5.launches, k5.variants = 0, {"tma_copy": 0, "general": 0}
    return k1, k5


def _launch(fn, body):
    fn.launches += 1
    fn.variants[body] += 1


class _StubGraph:
    """A replay: the step's work, with no Python counting."""

    def __init__(self, static):
        self.static = static

    def replay(self):
        self.static["x"] += 1


class _StubStepGraph(graphs.StepGraph):
    """StepGraph with the card's two passes stood in for: the warm-up runs
    the body, the capture runs it once more (as the capture pass runs the
    Python) and returns a stub graph. ``fail`` makes the first capture
    raise after its first launch."""

    fail = False

    def _warm_up(self):
        return self.body(self.static)

    def _capture_graph(self):
        if self.fail:
            self.fail = False
            _launch(self._wrappers[0], "tc_stream")
            raise RuntimeError("capture failed")
        # The capture pass runs the Python (and counts) but no kernel.
        x = self.static["x"].clone()
        outputs = self.body(self.static)
        self.static["x"].copy_(x)
        return _StubGraph(self.static), outputs


def _counting_body(k1, k5):
    def body(static):
        _launch(k1, "tc_stream")
        _launch(k1, "tc_stream")
        _launch(k1, "wgmma")
        _launch(k5, "tma_copy")
        static["x"] += 1
        return {"x": static["x"]}
    return body


@pytest.mark.parametrize("calls", [1, 2, 7])
def test_replays_credit_the_capture_counts(calls):
    """N calls of a captured step leave ``.launches`` and ``.variants`` at N
    times one eager step's, by body: the warm-up counts as a step, the
    capture pass's counts are taken back, each replay adds the delta."""
    k1, k5 = _stub_wrappers()
    body = _counting_body(k1, k5)
    static = {"x": torch.zeros(())}
    step = _StubStepGraph(body, static, capture=True, wrappers=(k1, k5))
    for _ in range(calls):
        step({})
    assert static["x"].item() == calls
    assert step.replays == calls - 1
    e1, e5 = _stub_wrappers()
    eager = _counting_body(e1, e5)
    for _ in range(calls):
        eager({"x": torch.zeros(())})
    assert (k1.launches, k1.variants) == (e1.launches, e1.variants)
    assert (k5.launches, k5.variants) == (e5.launches, e5.variants)
    assert k1.variants == {"tc_stream": 2 * calls, "wgmma": calls}


def test_failed_capture_counts_nothing_and_captures_again():
    """A capture (the second call's) that raises leaves no graph and no
    count of its own, lets the exception through, and the next call
    captures again, without another warm-up."""
    k1, k5 = _stub_wrappers()
    step = _StubStepGraph(_counting_body(k1, k5), {"x": torch.zeros(())},
                          capture=True, wrappers=(k1, k5))
    step.fail = True
    step({})                                             # the warm-up
    assert step.graph is None
    with pytest.raises(RuntimeError, match="capture failed"):
        step({})
    assert step.graph is None and step.credit is None
    assert k1.variants == {"tc_stream": 2, "wgmma": 1}   # the warm-up
    step({})
    step({})
    assert step.graph is not None and step.replays == 2
    assert k1.variants == {"tc_stream": 6, "wgmma": 3}
    assert k5.launches == 3


def test_credit_of_no_launch_is_empty():
    k1, k5 = _stub_wrappers()
    before = graphs.launch_counts((k1, k5))
    credit = graphs.LaunchCredit(before, graphs.launch_counts((k1, k5)))
    assert credit.delta == {}
    credit.apply(5)
    assert k1.launches == 0 and k5.variants == {"tma_copy": 0, "general": 0}


def test_copy_in_refuses_another_shape_and_copy_back_skips_in_place():
    static = {"caches": [{"k": torch.zeros(2, 3), "s": torch.zeros(2)}],
              "pos": torch.zeros(2, dtype=torch.long)}
    k = static["caches"][0]["k"]
    graphs.copy_in(static, {"pos": 7})
    assert static["pos"].tolist() == [7, 7]
    graphs.copy_in(static, {"pos": np.array([1, 2])})
    assert static["pos"].tolist() == [1, 2]
    with pytest.raises(ValueError, match="static leaf"):
        graphs.copy_in(static, {"pos": torch.zeros(3, dtype=torch.long)})
    new_s = torch.ones(2)
    graphs.copy_back(static["caches"], [{"k": k, "s": new_s}])
    assert static["caches"][0]["k"] is k
    assert static["caches"][0]["s"] is not new_s
    assert static["caches"][0]["s"].tolist() == [1.0, 1.0]


def test_eager_families_name_known_families():
    families = {tconfigs.get_config(a).family for a in tconfigs.ARCH_IDS}
    for family, reason in graphs.EAGER_FAMILIES:
        assert family in families and reason


# ---------------------------------------------------------------------------
# The numerics guard while a graph is being captured
# ---------------------------------------------------------------------------

def _nan_run(spec):
    return lambda low: torch.full((spec.m, spec.n), float("nan"))


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
def test_guard_reads_nothing_back_while_capturing(monkeypatch, on_card):
    """With the guard armed and ``torch.cuda.is_current_stream_capturing``
    patched to True, the runner returns the non-finite output without a
    read-back: it neither raises nor records."""
    reads = []
    monkeypatch.setattr(health, "has_nonfinite",
                        lambda out: reads.append(1) or True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    spec = ContractionSpec.dense(4, 8, 6, "float32")
    out = ctr.run_guarded(spec, LOWERINGS["torch_matmul"], _nan_run(spec),
                          on_card=on_card)
    assert torch.isnan(out).all()
    ctr.check_explicit_numerics(spec, LOWERINGS["tiling"], out)
    assert reads == [] and not health.HEALTH


def test_guard_still_degrades_or_raises_outside_a_capture(monkeypatch):
    """Unpatched, the armed guard reads the output back as before: on the
    CPU auto degrades down the chain and records it, on the card it raises
    NumericsError, and an explicit choice raises."""
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    assert not health.capturing()
    spec = ContractionSpec.dense(4, 8, 6, "float32")
    ctr.run_guarded(spec, LOWERINGS["torch_matmul"], _nan_run(spec))
    assert health.HEALTH
    health.clear_health()
    with pytest.raises(health.NumericsError, match="on the card"):
        ctr.run_guarded(spec, LOWERINGS["torch_matmul"], _nan_run(spec),
                        on_card=True)
    with pytest.raises(health.NumericsError, match="explicit"):
        ctr.check_explicit_numerics(spec, LOWERINGS["tiling"],
                                    _nan_run(spec)(None))
    assert not health.HEALTH
