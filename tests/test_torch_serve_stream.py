"""The port's request-stream front end (``repro_torch.serve.frontend``):
conservation, reject-newest shedding, step-granular deadlines, classified
retry converging bitwise, numerics-guard eviction, neighbour isolation and
the bounded registries — the clauses of ``tests/test_serve_stream.py`` on
the port — then parity with the JAX package's front end on the same numpy
weights and requests at temperature 0 (equal counters, statuses, greedy
tokens and lifecycle events, also under armed faults).

The bitwise self-comparisons sample at temperature 0.7 (a broken
per-(request, step) seed would show) and compare the port with its own
undisturbed run.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core import health as ref_health
from repro.serve import Request as RefRequest
from repro.serve import StreamConfig as RefStreamConfig
from repro.serve import StreamFrontend as RefStreamFrontend
from repro.serve import VirtualClock as RefVirtualClock
from repro.testing import faults as ref_faults
from repro_torch.configs import reduced_config
from repro_torch.core import health
from repro_torch.models import build
from repro_torch.serve import (Engine, Overloaded, Request, RequestResult,
                               ServeConfig, StreamConfig, StreamFrontend,
                               VirtualClock)
from repro_torch.serve.frontend import RETRYABLE_CLASSES
from repro_torch.testing import faults
from torch_serve_helpers import engines, lifecycle, numpy_tree, requests, tokens_of

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    cfg = dataclasses.replace(reduced_config("olmo-1b"),
                              compute_dtype="float32")
    model = build(cfg, device="cpu")
    return Engine(model, model.init(0),
                  ServeConfig(max_len=32, temperature=0.7, seed=3),
                  device="cpu")


@pytest.fixture(autouse=True)
def _isolate():
    faults.reset()
    health.clear_serve()
    health.clear_health()
    yield
    faults.reset()
    health.clear_serve()
    health.clear_health()


@pytest.fixture
def no_fault(monkeypatch):
    """Disarm any process-level REPRO_FAULT (targeted tests arm their own
    site via ``faults.inject``) and the numerics guard."""
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    faults.reset()


def _requests(n, *, seed=0, deadline_s=None):
    return requests(Request, n, seed=seed, budgets=(2, 3, 4),
                    deadline_s=deadline_s)


def _frontend(engine, **kw):
    clock = VirtualClock()
    cfg = StreamConfig(**{"queue_capacity": 8, "max_live": 2, **kw})
    return StreamFrontend(engine, cfg, clock=clock, sleep=clock.sleep), clock


def _serve_all(engine, reqs, **kw):
    fe, _ = _frontend(engine, **kw)
    for r in reqs:
        fe.submit(r)
    fe.drain()
    return fe


def _assert_conservation(fe, n_offered):
    c = fe.stats()
    assert c["offered"] == n_offered
    assert c["offered"] == c["admitted"] + c["shed"]
    assert c["admitted"] == (c["completed"] + c["evicted"]
                             + c["deadline_miss"])
    assert c["queued"] == 0 and c["live"] == 0
    assert len(fe.results) == n_offered
    assert all(r.status in health.TERMINAL_STATES
               for r in fe.results.values())


# ---------------------------------------------------------------------------
# Soak: Poisson arrivals under whatever site the environment armed
# ---------------------------------------------------------------------------

def test_soak_poisson_stream_conservation(engine, monkeypatch):
    site, _ = faults.active()   # hard error on a typo'd REPRO_FAULT
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    n = 100
    reqs = _requests(n, seed=1)
    gaps = np.random.default_rng(2).exponential(scale=0.35, size=n)
    schedule = list(zip(np.cumsum(gaps), reqs))   # Poisson arrivals
    clock = VirtualClock()
    fe = StreamFrontend(
        engine, StreamConfig(queue_capacity=12, max_live=4, max_retries=2,
                             backoff_base_s=0.001, backoff_cap_s=0.004),
        clock=clock, sleep=clock.sleep)
    results = fe.run(schedule, tick_s=1.0)

    _assert_conservation(fe, n)
    assert set(results) == {r.request_id for r in reqs}
    c = fe.stats()
    if site is None:
        assert c["completed"] > 0 and c["shed"] > 0
        assert c["evicted"] == 0
        for r in results.values():
            if r.status == "shed":
                assert isinstance(r, Overloaded)
            else:
                assert r.status == "completed" and len(r.tokens) > 0
    elif site == "engine_step":
        assert c["completed"] == 0
        assert c["evicted"] == c["admitted"] > 0
        assert c["retries"] >= c["evicted"] * 2
    elif site == "sample":
        assert c["completed"] == 0
        assert c["evicted"] == c["admitted"] > 0
    elif site == "admission":
        assert c["admitted"] == 0 and c["shed"] == n
        assert all(isinstance(r, Overloaded) for r in results.values())
    report = engine.serve_report()
    assert report["counters"] == {k: c[k] for k in report["counters"]}


# ---------------------------------------------------------------------------
# Targeted nth-hit behaviour (process-level site disarmed)
# ---------------------------------------------------------------------------

def test_single_step_fault_is_retried_bitwise(engine, no_fault):
    """Hit 4 of ``engine_step`` is a DECODE step (hits 1-2 prefill the two
    live slots, 3-4 decode them): the retried step's stream is bitwise the
    fault-free one."""
    base = _serve_all(engine, _requests(6, seed=3))
    assert all(r.status == "completed" for r in base.results.values())
    health.clear_serve()
    with faults.inject("engine_step", nth=4):
        fe = _serve_all(engine, _requests(6, seed=3), max_retries=2)
    c = fe.stats()
    assert c["completed"] == 6 and c["evicted"] == 0 and c["retries"] == 1
    for rid, r in base.results.items():
        np.testing.assert_array_equal(fe.results[rid].tokens, r.tokens)
    retried = [rec for rec in engine.serve_report()["requests"].values()
               if rec["retries"]]
    assert len(retried) == 1
    assert retried[0]["tokens_emitted"] > 0
    ev = [e for e in retried[0]["events"] if e["event"] == "retry"]
    assert ev and ev[0]["detail"] in RETRYABLE_CLASSES
    assert ev[0]["step"] == 1 and ev[0]["backoff_s"] > 0


def test_failure_after_the_in_place_write_retries_bitwise(engine, no_fault,
                                                          monkeypatch):
    """The port's decode writes the new position into the slot's caches in
    place; a step that fails AFTER that write (here: a runtime error
    raised once the decode returned) is retried from the same caches and
    its stream stays bitwise the fault-free one."""
    base = _serve_all(engine, _requests(4, seed=5))
    health.clear_serve()
    real = engine.decode_request
    calls = []

    def flaky(caches, token, pos):
        out = real(caches, token, pos)
        calls.append(pos)
        if len(calls) == 3:
            raise RuntimeError("device lost after the step")
        return out
    monkeypatch.setattr(engine, "decode_request", flaky)
    fe = _serve_all(engine, _requests(4, seed=5), max_retries=1)
    assert fe.stats()["retries"] == 1 and fe.stats()["completed"] == 4
    assert calls[2] == calls[3]          # the same position, written twice
    for rid, r in base.results.items():
        np.testing.assert_array_equal(fe.results[rid].tokens, r.tokens)


def test_step_fault_eviction_isolates_survivors_bitwise(engine, no_fault):
    base = _serve_all(engine, _requests(6, seed=3))
    health.clear_serve()
    with faults.inject("engine_step", nth=7):
        fe = _serve_all(engine, _requests(6, seed=3), max_retries=0)
    evicted = [rid for rid, r in fe.results.items() if r.status == "evicted"]
    assert len(evicted) == 1
    c = fe.stats()
    assert c["completed"] == 5 and c["evicted"] == 1
    for rid, r in base.results.items():
        if rid not in evicted:
            np.testing.assert_array_equal(fe.results[rid].tokens, r.tokens)
    partial = fe.results[evicted[0]].tokens
    np.testing.assert_array_equal(
        partial, base.results[evicted[0]].tokens[:len(partial)])


def test_numerics_guard_evicts_poisoned_request_bitwise(engine, no_fault,
                                                        monkeypatch):
    """NaN logits (the ``sample`` site, tensors filled by
    ``torch.full_like``) under REPRO_NUMERICS_GUARD evict exactly the
    poisoned request, with no retry; survivors are bitwise the undisturbed
    run."""
    base = _serve_all(engine, _requests(6, seed=3))
    health.clear_serve()
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    with faults.inject("sample", nth=5):
        fe = _serve_all(engine, _requests(6, seed=3), max_retries=2)
    evicted = [rid for rid, r in fe.results.items() if r.status == "evicted"]
    assert len(evicted) == 1
    c = fe.stats()
    assert c["evicted"] == 1 and c["completed"] == 5 and c["retries"] == 0
    assert fe.results[evicted[0]].detail.startswith("numerics")
    for rid, r in base.results.items():
        if rid not in evicted:
            np.testing.assert_array_equal(fe.results[rid].tokens, r.tokens)


def test_without_guard_poisoned_logits_complete_silently(engine, no_fault):
    with faults.inject("sample", nth=5):
        fe = _serve_all(engine, _requests(4, seed=3))
    assert all(r.status == "completed" for r in fe.results.values())


def test_admission_fault_sheds_typed_not_dropped(engine, no_fault):
    reqs = _requests(4, seed=5)
    with faults.inject("admission", nth=2):
        fe, _ = _frontend(engine)
        outcomes = [fe.submit(r) for r in reqs]
        fe.drain()
    assert outcomes[0] is None and outcomes[2] is None
    assert isinstance(outcomes[1], Overloaded)
    assert "admission failure (resource)" in outcomes[1].detail
    _assert_conservation(fe, 4)
    assert fe.stats()["completed"] == 3


# ---------------------------------------------------------------------------
# Backpressure, deadlines, budgets
# ---------------------------------------------------------------------------

def test_queue_overflow_rejects_newest_with_typed_overloaded(engine,
                                                             no_fault):
    fe, _ = _frontend(engine, queue_capacity=3, max_live=1)
    outcomes = [fe.submit(r) for r in _requests(7, seed=6)]
    assert [o is None for o in outcomes] == [True] * 3 + [False] * 4
    for o in outcomes[3:]:
        assert isinstance(o, Overloaded) and o.status == "shed"
        assert o.queue_depth == 3 and "queue full" in o.detail
    fe.drain()
    _assert_conservation(fe, 7)
    assert fe.stats() == {**fe.stats(), "completed": 3, "shed": 4}


def test_deadline_missed_mid_stream_returns_partial_tokens(engine, no_fault):
    req = Request(request_id=0, tokens=np.arange(1, 5, dtype=np.int32),
                  max_new_tokens=10, deadline_s=3.5)
    fe, clock = _frontend(engine)
    fe.submit(req)
    results = {}
    while not results:
        results.update(fe.step())
        clock.sleep(1.0)          # each tick costs 1 virtual second
    res = results[0]
    assert res.status == "deadline_miss"
    assert 0 < len(res.tokens) < 10 and res.latency_s > 3.5
    rec = engine.serve_report()["requests"]["0"]
    assert rec["status"] == "deadline_miss"
    assert rec["events"][-1]["event"] == "deadline_miss"


def test_token_budget_completes_exactly(engine, no_fault):
    fe = _serve_all(engine, [Request(request_id=9,
                                     tokens=np.arange(1, 7, dtype=np.int32),
                                     max_new_tokens=5)])
    res = fe.results[9]
    assert res.status == "completed" and len(res.tokens) == 5 and res.ok


def test_retry_backoff_is_capped_exponential(engine, no_fault):
    sleeps = []
    fe = StreamFrontend(
        engine,
        StreamConfig(max_retries=4, backoff_base_s=0.01, backoff_cap_s=0.04),
        clock=lambda: 0.0, sleep=sleeps.append)
    fe.submit(Request(request_id=0, tokens=np.arange(1, 5, dtype=np.int32),
                      max_new_tokens=2))
    with faults.inject("engine_step"):     # every hit fails
        fe.drain()
    assert fe.results[0].status == "evicted"
    assert sleeps == [0.01, 0.02, 0.04, 0.04]


def test_duplicate_request_id_is_an_error(engine, no_fault):
    fe, _ = _frontend(engine)
    fe.submit(Request(request_id=1, tokens=np.arange(1, 4, dtype=np.int32)))
    with pytest.raises(ValueError, match="duplicate"):
        fe.submit(Request(request_id=1,
                          tokens=np.arange(1, 4, dtype=np.int32)))
    fe.drain()


def test_request_and_result_validation():
    with pytest.raises(ValueError, match="non-empty"):
        Request(request_id=0, tokens=np.zeros((0,), np.int32))
    with pytest.raises(ValueError, match="non-terminal"):
        RequestResult(request_id=0, status="live", tokens=np.zeros(0))
    shed = Overloaded(request_id=0, status="completed", tokens=np.zeros(0))
    assert shed.status == "shed" and not shed.ok


# ---------------------------------------------------------------------------
# Per-request sampling determinism (the isolation substrate)
# ---------------------------------------------------------------------------

def test_request_stream_independent_of_neighbors(engine, no_fault):
    together = _serve_all(engine, _requests(5, seed=7))
    health.clear_serve()
    alone = _serve_all(engine, [_requests(5, seed=7)[2]])
    np.testing.assert_array_equal(alone.results[2].tokens,
                                  together.results[2].tokens)


# ---------------------------------------------------------------------------
# Fault sites and classes
# ---------------------------------------------------------------------------

def test_fault_grammar_and_classes(no_fault, monkeypatch):
    assert faults.FAULT_SITES == ref_faults.FAULT_SITES
    monkeypatch.setenv(faults.ENV_FAULT, "batch_step:1,3")
    assert faults.active() == ("batch_step", (1, 3))
    fired = []
    for _ in range(4):
        try:
            faults.maybe_fail("batch_step")
            fired.append(False)
        except faults.InjectedFault as exc:
            assert health.classify_failure(exc) == "runtime"
            fired.append(True)
    assert fired == [True, False, True, False] and faults.hits("batch_step") == 4
    # the two packages share only the variable: each counts its own hits
    assert ref_faults.hits("batch_step") == 0
    monkeypatch.setenv(faults.ENV_FAULT, "bogus")
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.active()
    monkeypatch.delenv(faults.ENV_FAULT)
    with faults.inject("checkpoint_read", nth=1):
        with pytest.raises(OSError):
            faults.maybe_fail("checkpoint_read")
    with faults.inject("sample"):
        x = torch.ones(2, 3)
        y = faults.corrupt("sample", x)
        assert y.shape == x.shape and y.dtype == x.dtype
        assert bool(torch.isnan(y).all()) and faults.corrupt("sample", None) is None
        assert health.has_nonfinite(y) and not health.has_nonfinite(x)
        assert bool(np.isnan(faults.corrupt("sample", np.ones(3))).all())


@pytest.mark.parametrize("exc,cls", [
    (MemoryError(), "resource"), (RuntimeError("CUDA out of memory"), "resource"),
    (NotImplementedError(), "unsupported"), (RuntimeError("nvcc failed"), "compile"),
    (RuntimeError("boom"), "runtime"), (health.NumericsError("nan"), "numerics")])
def test_classify_failure(exc, cls):
    assert health.classify_failure(exc) == cls


# ---------------------------------------------------------------------------
# Bounded, thread-safe registries
# ---------------------------------------------------------------------------

def test_health_registry_ring_bound_counts_drops():
    reg = health.HealthRegistry(max_records=2)
    for i in range(4):
        reg.record(f"spec{i}", "low", "runtime", "ref")
    assert len(reg) == 2 and reg.dropped == 2
    reg.record("spec3", "low", "runtime", "ref")
    assert [r.count for r in reg.records() if r.spec == "spec3"] == [2]
    reg.clear()
    assert len(reg) == 0 and reg.dropped == 0


def test_serve_registry_ring_prefers_dropping_terminal_rows():
    reg = health.ServeRegistry(max_records=3)
    for i in range(3):
        reg.admitted(i)
    reg.finalize(0, "completed", step=1, tokens_emitted=1, latency_s=0.0)
    reg.admitted(3)
    assert reg.dropped == 1
    report = reg.report()
    assert set(report["requests"]) == {"1", "2", "3"}
    assert report["counters"]["admitted"] == 4
    assert report["counters"]["completed"] == 1


def test_registries_are_thread_safe():
    reg = health.ServeRegistry(max_records=64)
    hreg = health.HealthRegistry(max_records=8)

    def work(base):
        for i in range(200):
            rid = base * 1000 + i
            reg.admitted(rid)
            reg.retry(rid, 0, "runtime", 0.001)
            reg.finalize(rid, "completed", step=1, tokens_emitted=1,
                         latency_s=0.0)
            hreg.record(f"spec{base}_{i % 16}", "low", "runtime", "ref")

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    c = reg.counters()
    assert c["admitted"] == c["completed"] == c["retries"] == 800
    assert len(reg) <= 64 and len(hreg) <= 8
    assert sum(r.count for r in hreg.records()) + hreg.dropped >= 8


def test_serve_report_schema(engine, no_fault):
    _serve_all(engine, _requests(2, seed=8))
    report = engine.serve_report()
    assert set(report) == {"counters", "dropped_records", "requests",
                           "dispatch_health"}
    assert set(report["counters"]) == {"offered", "admitted", "shed",
                                       "completed", "evicted",
                                       "deadline_miss", "retries",
                                       "preempted", "resumed"}
    rec = next(iter(report["requests"].values()))
    assert set(rec) == {"status", "retries", "tokens_emitted", "latency_s",
                        "events"}
    assert rec["events"][0]["event"] == "admitted"
    assert rec["events"][-1]["event"] == "completed"
    assert engine.health_report() == {}   # no guarded dispatch degraded


# ---------------------------------------------------------------------------
# Parity with the JAX package's front end (same numpy weights, temperature 0)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_pair():
    return engines(numpy_tree(0))


def _stream_both(pair, n, seed, site=None, nth=None, **kw):
    """Serve the same requests through both front ends under a VirtualClock
    and the same armed fault; (summary, tokens, stats) of each."""
    out = []
    for eng, Fe, Cfg, Clock, Req, hmod, fmod in (
            (pair[0], RefStreamFrontend, RefStreamConfig, RefVirtualClock,
             RefRequest, ref_health, ref_faults),
            (pair[1], StreamFrontend, StreamConfig, VirtualClock, Request,
             health, faults)):
        hmod.clear_serve()
        clock = Clock()
        fe = Fe(eng, Cfg(**{"queue_capacity": 8, "max_live": 2, **kw}),
                clock=clock, sleep=clock.sleep)
        with (fmod.inject(site, nth=nth) if site else _Null()):
            for r in requests(Req, n, seed=seed):
                fe.submit(r)
            fe.drain()
        out.append((lifecycle(eng.serve_report()), tokens_of(fe.results),
                    fe.stats()))
        hmod.clear_serve()
    return out


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("site,nth,guard,kw", [
    (None, None, False, {}),
    (None, None, False, {"queue_capacity": 3, "max_live": 1}),
    ("engine_step", 4, False, {}),
    ("engine_step", 7, False, {"max_retries": 0}),
    ("admission", 2, False, {}),
    ("sample", 5, True, {}),
])
def test_frontend_matches_reference(greedy_pair, no_fault, monkeypatch, site,
                                    nth, guard, kw):
    if guard:
        monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    want, got = _stream_both(greedy_pair, 8, 11, site, nth, **kw)
    assert got[2] == want[2]              # stats(): counters and depths
    assert got[0] == want[0]              # statuses, retries, events
    assert got[1] == want[1]              # greedy tokens
    assert any(len(t) > 1 and len(set(t)) > 1 for t in got[1].values())
