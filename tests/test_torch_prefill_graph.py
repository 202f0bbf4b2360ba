"""The prefill's graphs and the front end's batch-1 decode graph
(``repro_torch.serve.engine``) on the CPU, against the JAX package.

On the card ``Engine.generate`` and ``Engine.prefill_request`` replay one
prefill graph per input signature (no padding to length buckets), each
writing its caches into the static caches of the decode graph of its
width and layout, and ``decode_request`` replays the width-1 decode graph
over a copy of the request's caches. Here the graphs' bodies run
uncaptured over their static trees (``Engine._graphed = True`` on the
CPU), the function the card captures, and are held to the reference on
reduced configs in f32, the weights made with numpy and scaled by 4 so
that greedy decoding wanders: last-position logits within 1e-4 of the
reference's jit'd prefill's logit scale (the tolerance of
``tests/test_torch_families.py``), greedy tokens equal to the reference
``Engine.generate``'s. The front end over the graph route gives the
reference ``StreamFrontend``'s greedy streams, and its retries keep the
survivors bitwise; the scheduler over the prefill graphs gives its eager
route's tokens bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import health as ref_health
from repro.models import build as ref_build
from repro.serve import Request as RefRequest
from repro.serve import StreamConfig as RefStreamConfig
from repro.serve import StreamFrontend as RefStreamFrontend
from repro.serve import VirtualClock as RefVirtualClock
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.testing import faults as ref_faults
from repro_torch import configs as tconfigs
from repro_torch.core import health
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.serve import (ContinuousConfig, ContinuousScheduler, Engine,
                               Request, ServeConfig, StreamConfig,
                               StreamFrontend, VirtualClock, graphs)
from repro_torch.testing import faults
from torch_serve_helpers import lifecycle, requests, tokens_of

torch.set_num_threads(1)

PROMPT = (2, 6)
STEPS = 6
CASES = [("olmo-1b", True), ("olmo-1b", False), ("mixtral-8x22b", True),
         ("mamba2-130m", True), ("whisper-base", True),
         ("paligemma-3b", True)]


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    for h in (health, ref_health):
        h.clear_health()
        h.clear_serve()
    yield
    for mod in (faults, ref_faults):
        mod.reset()
    for h in (health, ref_health):
        h.clear_health()
        h.clear_serve()


def _engines(arch, pack, max_len=32, **serve):
    rcfg = dataclasses.replace(rconfigs.reduced_config(arch),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch),
                               compute_dtype="float32")
    tree = jax.tree.map(lambda x: np.asarray(x) * 4.0,
                        ref_build(rcfg).init(jax.random.PRNGKey(0)))
    ref = RefEngine(ref_build(rcfg), jax.tree.map(jnp.asarray, tree),
                    RefServeConfig(max_len=max_len, pack_weights=pack, **serve))
    port = Engine(build(tcfg, device="cpu"),
                  params_from_numpy(tree, tcfg, "cpu"),
                  ServeConfig(max_len=max_len, pack_weights=pack, **serve),
                  device="cpu")
    return ref, port, tcfg


def _batch(cfg, seed, rows=PROMPT[0], length=PROMPT[1]):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (rows, length)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (rows, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _port_batch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _tokens_shape(key) -> tuple:
    """The ``tokens`` shape of a prefill graph's key (its batch's
    ``graphs.signature``)."""
    return dict(key)["tokens"][0]


def _equal_trees(a, b) -> bool:
    la, lb = list(graphs._leaves(a)), list(graphs._leaves(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# The prefill through its graph body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,pack", CASES,
                         ids=[f"{a}-{'packed' if p else 'raw'}"
                              for a, p in CASES])
def test_prefill_graph_matches_the_reference(arch, pack):
    """The prefill graph's first call (the warm-up, which returns the
    caches) and its body (which writes them into the decode graph's static
    caches): the last-position logits within 1e-4 of the reference's jit'd
    prefill's logit scale, the caches bitwise the eager prefill's; then
    ``generate`` through the graphs gives the reference
    ``Engine.generate``'s greedy tokens and the eager route's."""
    ref, port, cfg = _engines(arch, pack)
    batch = _batch(cfg, seed=1)
    want, _ = ref._prefill(ref.params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    eager_logits, eager_caches = port._prefill(_port_batch(batch))
    port._graphed = True
    for call in range(2):
        logits, caches = port._graphed_prefill(_port_batch(batch))
        _close(logits.numpy(), want)
        assert torch.equal(logits, eager_logits), call
        assert _equal_trees(caches, eager_caches), call
    (step,) = port._prefill_graphs.values()
    (decode,) = port._graphs.values()
    assert step.static["caches"] is decode.static["caches"] is caches
    assert step.capture is False
    want_tokens = np.asarray(ref.generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, STEPS))
    got = port.generate(batch, STEPS)
    np.testing.assert_array_equal(got, want_tokens)
    port._graphed = False
    np.testing.assert_array_equal(port.generate(batch, STEPS), got)
    assert len(port._prefill_graphs) == len(port._graphs) == 1


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_two_prompt_lengths_at_one_width(arch):
    """A second prompt length gets a prefill graph of its own, writing the
    same static caches (the decode graph of that width); the first length,
    called again, gives bitwise the tokens it gave before, and each length
    the eager route's."""
    _, port, cfg = _engines(arch, True)
    port._graphed = True
    short, long_ = _batch(cfg, seed=2), _batch(cfg, seed=3, length=9)
    first = port.generate(short, STEPS)
    second = port.generate(long_, STEPS)
    again = port.generate(short, STEPS)
    assert len(port._prefill_graphs) == 2 and len(port._graphs) == 1
    keys = list(port._prefill_graphs)
    assert keys[0] != keys[1]
    (decode,) = port._graphs.values()
    assert all(g.static["caches"] is decode.static["caches"]
               for g in port._prefill_graphs.values())
    np.testing.assert_array_equal(again, first)
    port._graphed = False
    np.testing.assert_array_equal(port.generate(short, STEPS), first)
    np.testing.assert_array_equal(port.generate(long_, STEPS), second)
    assert not np.array_equal(first, second)


def test_prefill_request_returns_copies_of_the_width_1_static_caches():
    """``prefill_request`` through the graphs returns copies of the
    width-1 prefill graph's outputs (the decode graph's static caches,
    which the next request's prefill overwrites), bitwise the eager
    prefill's; ``decode_request`` copies a request's caches in, leaves
    them as they were and returns the static caches."""
    _, port, cfg = _engines("olmo-1b", True)
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 7))
    want_a, want_b = port.prefill_request(a), port.prefill_request(b)
    port._graphed = True
    logits_a, caches_a = port.prefill_request(a)
    assert torch.equal(logits_a, want_a[0]) and _equal_trees(caches_a, want_a[1])
    _, caches_b = port.prefill_request(b)
    (decode,) = port._graphs.values()
    static = decode.static["caches"]
    assert _equal_trees(caches_b, want_b[1]) and _equal_trees(static, caches_b)
    assert not any(x is y for x, y in zip(graphs._leaves(caches_b),
                                          graphs._leaves(static)))
    assert _equal_trees(caches_a, want_a[1])
    before = graphs.clone(caches_a)
    tok = torch.tensor([[3]], dtype=torch.int32)
    raw, out = port.decode_request(caches_a, tok, 5)
    assert _equal_trees(caches_a, before) and out is static
    port._graphed = False
    want_raw, _ = port.decode_request(caches_a, tok, 5)
    assert torch.equal(raw, want_raw)


WRITE_CASES = [("olmo-1b", None), ("mixtral-8x22b", None),
               ("mixtral-8x22b", 4), ("mamba2-130m", None),
               ("hymba-1.5b", None), ("whisper-base", None),
               ("paligemma-3b", None)]


@pytest.mark.parametrize("arch,window", WRITE_CASES,
                         ids=[a + (f"-window{w}" if w else "")
                              for a, w in WRITE_CASES])
def test_prefill_writes_the_caches_it_is_given(arch, window):
    """``model.prefill(..., caches=)`` (the prefill graph's body) writes
    its caches into the caches it is given, stale contents and all, and
    returns them: every leaf is a given tensor, bitwise the caches the
    prefill makes without them, the slots past the prompt zeroed; so the
    captured prefill allocates activations only. A window shorter than the
    prompt (the ring buffer's wrap) too."""
    cfg = dataclasses.replace(tconfigs.reduced_config(arch),
                              compute_dtype="float32")
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    model = build(cfg, device="cpu")
    params = model.init(0)
    batch = _port_batch(_batch(cfg, seed=5))
    kw = dict(max_len=16, cache_dtype=torch.bfloat16)
    want_logits, want = model.prefill(params, batch, **kw)
    given = graphs.static_like(want)
    for leaf in graphs._leaves(given):
        leaf.fill_(7)
    logits, got = model.prefill(params, batch, caches=given, **kw)
    assert all(x is y for x, y in zip(graphs._leaves(got),
                                      graphs._leaves(given)))
    assert len(list(graphs._leaves(got))) == len(list(graphs._leaves(want)))
    assert torch.equal(logits, want_logits) and _equal_trees(got, want)


# ---------------------------------------------------------------------------
# The front end's batch-1 decode graph
# ---------------------------------------------------------------------------

def _stream(engine, Fe, Cfg, Clock, Req, fmod, site=None, nth=None, n=8,
            seed=11, **kw):
    clock = Clock()
    fe = Fe(engine, Cfg(**{"queue_capacity": 8, "max_live": 2, **kw}),
            clock=clock, sleep=clock.sleep)
    armed = fmod.inject(site, nth=nth) if site else None
    if armed is not None:
        armed.__enter__()
    try:
        for r in requests(Req, n, seed=seed):
            fe.submit(r)
        fe.drain()
    finally:
        if armed is not None:
            armed.__exit__(None, None, None)
    return fe


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_frontend_on_the_graphs_matches_the_reference(arch):
    """``StreamFrontend`` over the graph route (each request's caches
    copied into the width-1 decode graph's and back at the commit) gives
    the reference ``StreamFrontend``'s greedy streams, statuses and
    lifecycle events, and the eager route's streams."""
    ref, port, _ = _engines(arch, True)
    want = _stream(ref, RefStreamFrontend, RefStreamConfig, RefVirtualClock,
                   RefRequest, ref_faults)
    want_life = lifecycle(ref.serve_report())
    port._graphed = True
    got = _stream(port, StreamFrontend, StreamConfig, VirtualClock, Request,
                  faults)
    got_life = lifecycle(port.serve_report())
    health.clear_serve()
    assert tokens_of(got.results) == tokens_of(want.results)
    assert got_life == want_life
    assert len(port._graphs) == 1
    assert {_tokens_shape(k)[0] for k in port._prefill_graphs} == {1}
    port._graphed = False
    eager = _stream(port, StreamFrontend, StreamConfig, VirtualClock, Request,
                    faults)
    assert tokens_of(eager.results) == tokens_of(got.results)
    assert any(len(set(t)) > 1 for t in tokens_of(got.results).values())


@pytest.mark.parametrize("site,nth,guard,kw", [
    ("engine_step", 4, False, {}),
    ("engine_step", 7, False, {"max_retries": 0}),
    ("sample", 5, True, {}),
], ids=["retried", "evicted", "sample-guard"])
def test_frontend_retries_on_the_graphs_keep_survivors_bitwise(
        monkeypatch, site, nth, guard, kw):
    """A step retried under ``engine_step``, a step evicted, and a
    ``sample`` corruption under the numerics guard, through the graph
    route: every surviving stream bitwise the undisturbed run's, the
    retried one included, and each run equal to the eager route's."""
    _, port, _ = _engines("olmo-1b", True, temperature=0.7, seed=3)
    port._graphed = True
    base = tokens_of(_stream(port, StreamFrontend, StreamConfig, VirtualClock,
                             Request, faults).results)
    health.clear_serve()
    if guard:
        monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    runs = {}
    for graphed in (True, False):
        port._graphed = graphed
        fe = _stream(port, StreamFrontend, StreamConfig, VirtualClock, Request,
                     faults, site, nth, **kw)
        runs[graphed] = ({rid: (r.status, np.asarray(r.tokens).tolist())
                          for rid, r in fe.results.items()}, fe.stats())
        health.clear_serve()
    assert runs[True] == runs[False]
    results, stats = runs[True]
    evicted = [rid for rid, (status, _) in results.items()
               if status == "evicted"]
    assert len(evicted) == (0 if site == "engine_step" and nth == 4 else 1)
    assert stats["retries"] == (1 if nth == 4 else 0)
    for rid, (status, toks) in results.items():
        if rid in evicted:
            assert toks == base[rid][:len(toks)]
        else:
            assert toks == base[rid]


# ---------------------------------------------------------------------------
# The scheduler's admissions and resumes over the prefill graphs
# ---------------------------------------------------------------------------

def _schedule(engine, graphed, **kw):
    engine._graphed = graphed
    clock = VirtualClock()
    cs = ContinuousScheduler(engine, ContinuousConfig(
        queue_capacity=32, max_live=3, block_size=8, max_retries=1, **kw),
        clock=clock, sleep=clock.sleep)
    for r in requests(Request, 8, seed=1):
        cs.submit(r)
    cs.drain(max_ticks=20_000)
    assert cs.kv.alloc.free_count == cs.kv.alloc.capacity
    stats = cs.stats()
    health.clear_serve()
    return stats, {rid: (res.status, res.tokens.tolist())
                   for rid, res in cs.results.items()}


@pytest.mark.parametrize("kw", [{}, {"num_kv_blocks": 3},
                                {"kv_quantize": "int8"}],
                         ids=["float-pool", "preempt-resume", "int8-pool"])
def test_scheduler_over_the_prefill_graphs_is_bitwise_eager(kw):
    """``ContinuousScheduler`` with the engine's prefill graphs (every
    admission and resume through ``prefill_request``'s graph, one per
    prompt length) and its step's graph gives the eager route's statuses,
    statistics and tokens bitwise, on the float and int8 pools, under
    preemption and resume; the pool drains."""
    _, port, _ = _engines("olmo-1b", True)
    graphed = _schedule(port, True, **kw)
    lengths = {_tokens_shape(k)[1] for k in port._prefill_graphs}
    assert lengths == {len(r.tokens) for r in requests(Request, 8, seed=1)}
    eager = _schedule(port, False, **kw)
    assert graphed == eager
    if "num_kv_blocks" in kw:
        assert graphed[0]["preempted"] >= 1
        assert graphed[0]["resumed"] == graphed[0]["preempted"]
