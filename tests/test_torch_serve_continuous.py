"""The port's continuous-batching scheduler (``repro_torch.serve.scheduler``)
over its paged KV pool (``repro_torch.serve.kv_cache``): allocator units,
unpageable shapes refused, preempt / resume bitwise under exhaustion with
the deadline kept, a batch fault retried bitwise, bisection that
exonerates all and bisection that evicts exactly one, ``kv_alloc``
retried, the watchdog, shedding, oversized requests refused, the typed
``kv_leak``, the int8 pool, a Poisson soak and the property sweep — the
clauses of ``tests/test_serve_continuous.py`` on the port — then parity
with the JAX package's scheduler on the same numpy weights and requests at
temperature 0, with and without KV pressure and under armed faults.

Bitwise self-comparisons sample at temperature 0.7 and compare each run
with the port's own undisturbed scheduler run. The scheduler is compared
with the port's batch-1 ``StreamFrontend`` on greedy tokens and on logits
within 1e-5 of the logit scale only: on the CPU the two are not bit-equal,
because a product at M=1 takes another path than at M=max_live (``x @ w``
at M=1 and M=3 differ by ~1e-7), and the scheduler's single-row paths run
its width-``max_live`` step for that reason.
"""
import dataclasses

import numpy as np
import pytest
import torch

from hypo import HAVE_HYPOTHESIS, given, settings, st

from repro.core import health as ref_health
from repro.serve import ContinuousConfig as RefContinuousConfig
from repro.serve import ContinuousScheduler as RefContinuousScheduler
from repro.serve import Request as RefRequest
from repro.serve import VirtualClock as RefVirtualClock
from repro.serve.kv_cache import quantize_kv_position as ref_quantize_kv_position
from repro.testing import faults as ref_faults
from repro_torch.configs import reduced_config
from repro_torch.core import health
from repro_torch.models import build
from repro_torch.serve import (BlockAllocator, ContinuousConfig,
                               ContinuousScheduler, Engine, Overloaded,
                               PagedKVCache, Request, ServeConfig,
                               StreamConfig, StreamFrontend, VirtualClock)
from repro_torch.serve.kv_cache import quantize_kv_position
from repro_torch.testing import faults
from torch_serve_helpers import engines, lifecycle, numpy_tree, requests, tokens_of

torch.set_num_threads(1)


def _engine(temperature=0.7):
    cfg = dataclasses.replace(reduced_config("olmo-1b"),
                              compute_dtype="float32")
    model = build(cfg, device="cpu")
    return Engine(model, model.init(0),
                  ServeConfig(max_len=32, temperature=temperature, seed=3),
                  device="cpu")


@pytest.fixture(scope="module")
def engine():
    return _engine()


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
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    faults.reset()


def _requests(n, *, seed=0, deadline_s=None):
    return requests(Request, n, seed=seed, deadline_s=deadline_s)


def _sched(engine, **kw):
    clock = VirtualClock()
    cfg = ContinuousConfig(**{"queue_capacity": 32, "max_live": 3,
                              "block_size": 8, **kw})
    return (ContinuousScheduler(engine, cfg, clock=clock, sleep=clock.sleep),
            clock)


def _serve_all(engine, reqs, **kw):
    cs, _ = _sched(engine, **kw)
    for r in reqs:
        cs.submit(r)
    cs.drain(max_ticks=20_000)
    return cs


def _assert_conservation(cs, n_offered=None):
    """The EXTENDED invariant, closed (quiescent: nothing open/preempted)."""
    s = cs.stats()
    assert s["offered"] == s["admitted"] + s["shed"]
    assert s["admitted"] == (s["completed"] + s["evicted"]
                             + s["deadline_miss"] + s["queued"] + s["live"]
                             + s["preempted_open"])
    assert s["queued"] == 0 and s["live"] == 0 and s["preempted_open"] == 0
    assert s["resumed"] <= s["preempted"]
    if n_offered is not None:
        assert s["offered"] == n_offered
        assert len(cs.results) == n_offered
    assert cs.kv.alloc.free_count == cs.kv.alloc.capacity
    assert cs.kv.accounting_consistent()
    return s


def _undisturbed(engine, reqs, **kw):
    """The port's own undisturbed scheduler run (the bitwise oracle)."""
    cs = _serve_all(engine, reqs, **kw)
    ref = {rid: res.tokens.copy() for rid, res in cs.results.items()}
    health.clear_serve()
    return ref


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# Allocator / paged-cache units
# ---------------------------------------------------------------------------

def test_allocator_deterministic_lowest_first(no_fault):
    a = BlockAllocator(6)
    assert a.try_alloc(2) == [1, 2]
    assert a.try_alloc(1) == [3]
    a.free([2])
    assert a.try_alloc(2) == [2, 4]
    assert a.free_count + a.used_count == a.capacity


def test_allocator_exhaustion_is_typed_not_raised(no_fault):
    a = BlockAllocator(2)
    assert a.try_alloc(3) is None
    assert a.free_count == 2
    got = a.try_alloc(2)
    assert a.try_alloc(1) is None
    a.free(got)
    assert a.free_count == a.capacity
    with pytest.raises(ValueError, match="at least one"):
        BlockAllocator(0)


def test_allocator_double_free_detected(no_fault):
    a = BlockAllocator(2)
    got = a.try_alloc(1)
    a.free(got)
    with pytest.raises(ValueError, match="double free"):
        a.free(got)
    with pytest.raises(ValueError, match="double free"):
        a.free([2])


def test_kv_alloc_fault_site_fires_in_try_alloc(no_fault):
    a = BlockAllocator(4)
    with faults.inject("kv_alloc", nth=2):
        assert a.try_alloc(1) == [1]
        with pytest.raises(faults.InjectedFault) as ei:
            a.try_alloc(1)
        assert ei.value.failure_class == "resource"
        assert a.free_count == 3


def test_paged_cache_rejects_unpageable_shapes(engine):
    cfg = engine.model.cfg
    mk = dict(max_live=2, max_len=32, block_size=8, num_blocks=8,
              device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        PagedKVCache(cfg, **{**mk, "max_len": 30})
    swa = dataclasses.replace(cfg, attention_type="sliding_window",
                              sliding_window=8)
    with pytest.raises(ValueError, match="not pageable"):
        PagedKVCache(swa, **mk)
    for family in ("ssm", "vlm"):
        with pytest.raises(ValueError, match="not pageable"):
            PagedKVCache(dataclasses.replace(cfg, family=family,
                                             ssm_state_size=16), **mk)
    with pytest.raises(ValueError, match="not pageable"):
        PagedKVCache(dataclasses.replace(cfg, is_encoder_decoder=True), **mk)
    mixtral = dataclasses.replace(reduced_config("mixtral-8x22b"))
    assert mixtral.attention_type == "sliding_window"
    with pytest.raises(ValueError, match="not pageable"):
        PagedKVCache(mixtral, **mk)


def test_gathered_view_of_a_full_table_is_the_dense_cache(engine, no_fault):
    """A fully tabled slot gathers to exactly the dense ``max_len`` cache
    that prefill / decode use, layer by layer; write_position commits one
    decoded position; release scrubs."""
    kv = PagedKVCache(engine.model.cfg, max_live=2, max_len=32, block_size=8,
                      num_blocks=8, device="cpu")
    _, caches = engine.prefill_request(np.arange(1, 7, dtype=np.int32))
    assert kv.grow(1, 32) and kv.slot_block_count(1) == 4
    kv.insert_dense(1, caches)
    got = kv.gather_slot(1)
    assert len(got) == len(caches)
    for want_l, got_l in zip(caches, got):
        for name in ("k", "v"):
            assert torch.equal(got_l["kv"][name], want_l["kv"][name])
    _, caches = engine.decode_request(caches, torch.tensor([[5]]), 6)
    kv.write_position(1, 6, caches)
    for want_l, got_l in zip(caches, kv.gather_slot(1)):
        assert torch.equal(got_l["kv"]["k"], want_l["kv"]["k"])
    with pytest.raises(ValueError, match="not backed"):
        kv.write_position(0, 3, caches)
    assert kv.pool_bytes() == 2 * 2 * 9 * 8 * 4 * 16 * 4
    assert kv.bytes_per_block() == kv.pool_bytes() // 9
    kv.release(1)
    assert not bool(kv.pool["k"].any()) and kv.accounting_consistent()
    assert kv.alloc.free_count == kv.alloc.capacity


# ---------------------------------------------------------------------------
# The batched step: rows independent at a fixed width; close to batch-1
# ---------------------------------------------------------------------------

def _mid_flight(engine, **kw):
    """A scheduler with three live rows at different positions."""
    cs, _ = _sched(engine, **kw)
    for i, length in enumerate((4, 7, 5)):
        cs.submit(Request(request_id=i, max_new_tokens=8,
                          tokens=np.arange(length, dtype=np.int32) + 3 * i))
    cs.step()
    cs.step()
    assert len(cs._live) == 3
    return cs


def _step_inputs(cs):
    tokens = np.zeros((cs.cfg.max_live, 1), np.int64)
    pos = np.zeros((cs.cfg.max_live,), np.int64)
    for row, slot in cs._live.items():
        tokens[row, 0] = slot.emitted[-1]
        pos[row] = slot.req.tokens.shape[0] + len(slot.emitted) - 1
    return tokens, pos


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_batched_row_is_bitwise_the_row_alone(engine, no_fault, kv_quantize):
    """A row of the shared step equals, bit for bit, the same row run at the
    same width with every other row dead — the property the bisection
    re-run and the resume replay stand on — and the pool is untouched until
    the step is committed."""
    cs = _mid_flight(engine, kv_quantize=kv_quantize)
    pool = {n: t.clone() for n, t in cs.kv.pool.items()}
    tokens, pos = _step_inputs(cs)
    logits, written = cs._step(cs.kv.device_tables(), tokens, pos)
    for n, t in cs.kv.pool.items():
        assert torch.equal(t, pool[n])       # the step wrote into a copy
    for row in cs._live:
        alone, w1 = cs._row_step(row, int(tokens[row, 0]), int(pos[row]))
        assert torch.equal(alone[row], logits[row])
        for layer in range(len(written[0])):
            for name in ("k", "v"):
                assert torch.equal(w1[0][layer]["kv"][name][row, pos[row]],
                                   written[0][layer]["kv"][name][row, pos[row]])


def test_batched_step_close_to_batch1_decode(engine, no_fault):
    """Against the port's batch-1 decode on the gathered slot: logits
    within 1e-5 of their scale (not bit-equal on the CPU: M=1 against
    M=max_live) and the same argmax."""
    cs = _mid_flight(engine)
    tokens, pos = _step_inputs(cs)
    logits, _ = cs._step(cs.kv.device_tables(), tokens, pos)
    for row in cs._live:
        raw, _ = engine.decode_request(cs.kv.gather_slot(row),
                                       torch.tensor([[int(tokens[row, 0])]]),
                                       int(pos[row]))
        want = raw[0, 0]
        scale = float(want.abs().max())
        assert float((logits[row] - want).abs().max()) <= 1e-5 * scale
        assert int(logits[row].argmax()) == int(want.argmax())


def test_continuous_matches_batch1_greedy(no_fault):
    """Greedy: the scheduler's tokens equal the batch-1 front end's."""
    greedy = _engine(temperature=0.0)
    fe = StreamFrontend(greedy, StreamConfig(queue_capacity=64, max_live=2),
                        clock=VirtualClock())
    for r in _requests(8, seed=1):
        fe.submit(r)
    fe.drain()
    health.clear_serve()
    cs = _serve_all(greedy, _requests(8, seed=1))
    s = _assert_conservation(cs, 8)
    assert s["completed"] == 8 and s["preempted"] == 0
    for rid, res in fe.results.items():
        np.testing.assert_array_equal(cs.results[rid].tokens, res.tokens)


# ---------------------------------------------------------------------------
# KV backpressure: preempt + resume, bitwise; exhaustion never crashes
# ---------------------------------------------------------------------------

def test_kv_exhaustion_preempts_and_resumes_bitwise(engine, no_fault):
    ref = _undisturbed(engine, _requests(8, seed=1))
    cs = _serve_all(engine, _requests(8, seed=1), num_kv_blocks=3)
    s = _assert_conservation(cs, 8)
    assert s["completed"] == 8 and s["evicted"] == 0
    assert s["preempted"] >= 1 and s["resumed"] == s["preempted"]
    for rid, toks in ref.items():
        np.testing.assert_array_equal(cs.results[rid].tokens, toks)
    report = engine.serve_report()
    bounced = [rec for rec in report["requests"].values()
               if any(e["event"] == "preempted" for e in rec["events"])]
    assert bounced
    for rec in bounced:
        events = [e["event"] for e in rec["events"]]
        assert events.index("preempted") < events.index("resumed")
        assert rec["status"] == "completed"
    assert any(r.preemptions > 0 for r in cs.results.values())


def test_preempted_request_keeps_original_deadline(engine, no_fault):
    reqs = [Request(request_id=i, tokens=np.arange(4, dtype=np.int32) + i,
                    max_new_tokens=20, deadline_s=0.5)
            for i in range(3)]
    cs, clock = _sched(engine, num_kv_blocks=3, max_live=3)
    for r in reqs:
        cs.submit(r)
    for _ in range(200):
        if not (cs._queue or cs._live):
            break
        cs.step()
        clock.sleep(0.2)
    s = _assert_conservation(cs, 3)
    assert s["deadline_miss"] >= 1
    assert s["deadline_miss"] + s["completed"] + s["evicted"] == 3


def test_preempted_request_deadline_runs_from_first_admission(engine,
                                                               no_fault):
    """A request preempted mid-stream waits at the queue front with the
    clock of its FIRST admission: it misses its deadline in the queue, with
    its tokens so far, and its latency counts from that admission."""
    reqs = [Request(request_id=i, tokens=np.arange(4, dtype=np.int32) + i,
                    max_new_tokens=20, deadline_s=2.0)
            for i in range(3)]
    cs, clock = _sched(engine, num_kv_blocks=4, max_live=3)
    for r in reqs:
        cs.submit(r)
    for _ in range(200):
        if not (cs._queue or cs._live):
            break
        cs.step()
        clock.sleep(0.2)
    s = _assert_conservation(cs, 3)
    assert s["preempted"] >= 1
    parked = [r for r in cs.results.values() if r.preemptions]
    assert parked
    for res in parked:
        assert res.status == "deadline_miss" and "in queue" in res.detail
        assert res.latency_s > 2.0 and len(res.tokens) > 0


# ---------------------------------------------------------------------------
# Blast-radius containment: retry, then bisection
# ---------------------------------------------------------------------------

def test_single_batch_fault_retries_bitwise(engine, no_fault):
    ref = _undisturbed(engine, _requests(6, seed=2))
    with faults.inject("batch_step", nth=2):
        cs = _serve_all(engine, _requests(6, seed=2), max_retries=2)
    s = _assert_conservation(cs, 6)
    assert s["completed"] == 6 and s["evicted"] == 0 and s["retries"] >= 1
    for rid, toks in ref.items():
        np.testing.assert_array_equal(cs.results[rid].tokens, toks)


def test_bisection_exonerates_all_when_no_row_guilty(engine, no_fault):
    ref = _undisturbed(engine, _requests(6, seed=2))
    with faults.inject("batch_step", nth=(1, 2)):
        cs = _serve_all(engine, _requests(6, seed=2), max_retries=1)
    s = _assert_conservation(cs, 6)
    assert s["completed"] == 6 and s["evicted"] == 0
    for rid, toks in ref.items():
        np.testing.assert_array_equal(cs.results[rid].tokens, toks)
    verdicts = [e["detail"].split(":")[0]
                for rec in engine.serve_report()["requests"].values()
                for e in rec["events"] if e["event"] == "bisect"]
    assert verdicts and set(verdicts) == {"exonerated"}


def test_bisection_evicts_exactly_one_guilty_row(engine, no_fault):
    ref = _undisturbed(engine, _requests(8, seed=1))
    with faults.inject("batch_step", nth=(1, 2, 3)):
        cs = _serve_all(engine, _requests(8, seed=1), max_retries=1)
    s = _assert_conservation(cs, 8)
    assert s["evicted"] == 1 and s["completed"] == 7
    evicted = [rid for rid, r in cs.results.items() if r.status == "evicted"]
    assert "bisection" in cs.results[evicted[0]].detail
    for rid, toks in ref.items():
        if rid in evicted:
            partial = cs.results[rid].tokens
            np.testing.assert_array_equal(partial, toks[:len(partial)])
        else:
            np.testing.assert_array_equal(cs.results[rid].tokens, toks)
    guilty = [rec for rec in engine.serve_report()["requests"].values()
              if any(e["event"] == "bisect" and e["detail"].startswith("guilty")
                     for e in rec["events"])]
    assert len(guilty) == 1 and guilty[0]["status"] == "evicted"


def test_injected_kv_alloc_fault_is_retried_bitwise(engine, no_fault):
    ref = _undisturbed(engine, _requests(6, seed=4))
    with faults.inject("kv_alloc", nth=3):
        cs = _serve_all(engine, _requests(6, seed=4), max_retries=2)
    s = _assert_conservation(cs, 6)
    assert s["completed"] == 6 and s["evicted"] == 0 and s["retries"] >= 1
    for rid, toks in ref.items():
        np.testing.assert_array_equal(cs.results[rid].tokens, toks)


def test_kv_alloc_fault_past_retries_evicts_typed(engine, no_fault):
    with faults.inject("kv_alloc"):
        cs = _serve_all(engine, _requests(3, seed=4), max_retries=1)
    s = _assert_conservation(cs, 3)
    assert s["evicted"] == 3 and s["retries"] == 3
    assert all("kv allocation failed (resource)" in r.detail
               for r in cs.results.values())


def test_numerics_guard_evicts_only_the_poisoned_row(engine, no_fault,
                                                     monkeypatch):
    """A NaN logits row of the shared step (here: row 1 of the third
    batched step, poisoned after the step) evicts that row alone; the
    other rows are bitwise the undisturbed run."""
    ref = _undisturbed(engine, _requests(6, seed=2))
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    cs, _ = _sched(engine)
    real, calls = cs._step, []

    def poisoned(tables, tokens, pos):
        logits, written = real(tables, tokens, pos)
        calls.append(1)
        if len(calls) == 3:
            logits = logits.clone()
            logits[1] = float("nan")
        return logits, written
    monkeypatch.setattr(cs, "_step", poisoned)
    for r in _requests(6, seed=2):
        cs.submit(r)
    cs.drain(max_ticks=20_000)
    s = _assert_conservation(cs, 6)
    assert s["evicted"] == 1 and s["completed"] == 5 and s["retries"] == 0
    for rid, res in cs.results.items():
        if res.status == "evicted":
            assert res.detail.startswith("numerics")
            np.testing.assert_array_equal(res.tokens, ref[rid][:len(res.tokens)])
        else:
            np.testing.assert_array_equal(res.tokens, ref[rid])


# ---------------------------------------------------------------------------
# Watchdog, shedding, validation, leaks
# ---------------------------------------------------------------------------

def test_watchdog_deadline_checked_at_step_granularity(engine, no_fault):
    cs, clock = _sched(engine)
    cs.submit(Request(request_id=0, tokens=np.arange(4, dtype=np.int32),
                      max_new_tokens=25, deadline_s=0.3))
    for _ in range(100):
        done = cs.step()
        clock.sleep(0.1)
        if done:
            break
    res = cs.results[0]
    assert res.status == "deadline_miss" and 0 < len(res.tokens) < 25
    _assert_conservation(cs, 1)


def test_queue_full_sheds_typed(engine, no_fault):
    cs, _ = _sched(engine, queue_capacity=2, max_live=1)
    outcomes = [cs.submit(r) for r in _requests(5, seed=6)]
    shed = [o for o in outcomes if o is not None]
    assert len(shed) == 3 and all(isinstance(o, Overloaded) for o in shed)
    cs.drain(max_ticks=20_000)
    _assert_conservation(cs, 5)


def test_oversized_request_rejected_loudly(engine, no_fault):
    cs, _ = _sched(engine)
    with pytest.raises(ValueError, match="exceeds max_len"):
        cs.submit(Request(request_id=0, tokens=np.zeros((30,), np.int32),
                          max_new_tokens=16))
    cs.submit(Request(request_id=1, tokens=np.zeros((20,), np.int32),
                      max_new_tokens=4))
    with pytest.raises(ValueError, match="duplicate"):
        cs.submit(Request(request_id=1, tokens=np.zeros((4,), np.int32)))
    cs.drain()


def test_request_larger_than_the_pool_is_evicted_typed(engine, no_fault):
    cs = _serve_all(engine, [Request(request_id=0,
                                     tokens=np.arange(20, dtype=np.int32),
                                     max_new_tokens=4)], num_kv_blocks=2)
    s = _assert_conservation(cs, 1)
    assert s["evicted"] == 1 and "pool capacity 2" in cs.results[0].detail


def test_drain_detects_kv_leak_typed(engine, no_fault):
    cs, _ = _sched(engine)
    assert cs.kv.alloc.try_alloc(1)    # steal a block behind the scheduler
    with pytest.raises(RuntimeError, match="kv_leak"):
        cs.drain(max_ticks=100)
    report = engine.health_report()
    leak = [rec for rec in report.values() if rec["cause"] == "kv_leak"]
    assert len(leak) == 1 and "1 of" in leak[0]["detail"]


# ---------------------------------------------------------------------------
# Soak and the property sweep
# ---------------------------------------------------------------------------

def test_soak_poisson_continuous_conservation(engine, monkeypatch):
    site, _ = faults.active()
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    n = 60
    reqs = _requests(n, seed=7)
    gaps = np.random.default_rng(8).exponential(scale=0.3, size=n)
    schedule = list(zip(np.cumsum(gaps), reqs))
    clock = VirtualClock()
    cs = ContinuousScheduler(
        engine,
        ContinuousConfig(queue_capacity=10, max_live=4, max_retries=1,
                         backoff_base_s=0.001, backoff_cap_s=0.004,
                         block_size=8, num_kv_blocks=6),
        clock=clock, sleep=clock.sleep)
    results = cs.run(schedule, tick_s=1.0)
    s = _assert_conservation(cs)
    assert set(results) == {r.request_id for r in reqs}
    if site is None:
        assert s["completed"] > 0 and s["preempted"] > 0
        assert s["evicted"] == 0
    elif site in ("kv_alloc", "batch_step"):
        assert s["completed"] == 0
        assert s["evicted"] == s["admitted"] > 0
    report = engine.serve_report()
    assert report["counters"] == {k: s[k] for k in report["counters"]}


def _property_case(engine, *, n, seed, num_blocks, fault_site, fault_nth,
                   kv_quantize=None):
    """One draw: serve a random stream under a KV budget and a fault
    placement; the invariant closes, the pool does not leak, and every
    stream is bitwise (a prefix of) the roomy undisturbed run's."""
    faults.reset()
    health.clear_serve()
    ref = _undisturbed(engine, _requests(n, seed=seed),
                       kv_quantize=kv_quantize)
    ctx = (faults.inject(fault_site, nth=fault_nth) if fault_site
           else _Null())
    with ctx:
        cs = _serve_all(engine, _requests(n, seed=seed),
                        num_kv_blocks=num_blocks, max_retries=1,
                        kv_quantize=kv_quantize)
    s = _assert_conservation(cs, n)
    assert s["resumed"] == s["preempted"]
    for rid, res in cs.results.items():
        if res.status == "completed":
            np.testing.assert_array_equal(res.tokens, ref[rid])
        else:
            np.testing.assert_array_equal(res.tokens,
                                          ref[rid][:len(res.tokens)])
    return s


@pytest.mark.parametrize("seed,num_blocks,fault_site,fault_nth", [
    (11, 3, None, None),              # heavy KV pressure, healthy
    (12, 4, "kv_alloc", 2),           # alloc fault under pressure
    (13, 3, "batch_step", (2, 3)),    # batch fault + guilty re-run
    (14, 12, "batch_step", 1),        # transient batch fault, no pressure
    (15, 2, None, None),              # extreme pressure: 2 blocks
])
def test_property_grid(engine, no_fault, seed, num_blocks, fault_site,
                       fault_nth):
    _property_case(engine, n=6, seed=seed, num_blocks=num_blocks,
                   fault_site=fault_site, fault_nth=fault_nth)


_PROPERTY_ENGINE = []


def _property_engine():
    if not _PROPERTY_ENGINE:
        _PROPERTY_ENGINE.append(_engine())
    return _PROPERTY_ENGINE[0]


if HAVE_HYPOTHESIS:
    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 10_000),
           num_blocks=st.integers(2, 14),
           fault=st.sampled_from([None, "kv_alloc", "batch_step"]),
           nth=st.integers(1, 6),
           kv_quantize=st.sampled_from([None, "int8"]))
    def test_property_sweep_conservation_bitwise_no_leak(seed, num_blocks,
                                                         fault, nth,
                                                         kv_quantize):
        import os
        os.environ.pop(faults.ENV_FAULT, None)
        os.environ.pop(health.ENV_NUMERICS_GUARD, None)
        _property_case(_property_engine(), n=5, seed=seed,
                       num_blocks=num_blocks, fault_site=fault, fault_nth=nth,
                       kv_quantize=kv_quantize)
else:  # keep the node visible (and skipping) without hypothesis
    @given()
    def test_property_sweep_conservation_bitwise_no_leak():
        pass  # pragma: no cover


# ---------------------------------------------------------------------------
# Quantized paged-KV pool (ContinuousConfig.kv_quantize="int8")
# ---------------------------------------------------------------------------

def test_paged_cache_quantized_units(engine, no_fault):
    cfg = engine.model.cfg
    mk = dict(max_live=2, max_len=32, block_size=8, num_blocks=8, device="cpu")
    kv = PagedKVCache(cfg, **mk, quantize="int8")
    f32 = PagedKVCache(cfg, **mk)
    assert kv.pool["k"].dtype == torch.int8
    assert kv.scales["k"].shape == kv.pool["k"].shape[:3]
    assert bool((kv.scales["k"] == 1.0).all())
    assert kv.pool_bytes() < 0.3 * f32.pool_bytes()
    assert kv.bytes_per_block() < f32.bytes_per_block() // 3
    _, caches = engine.prefill_request(np.arange(6, dtype=np.int32))
    assert kv.grow(0, 6)
    kv.insert_dense(0, caches)
    got = kv.gather_slot(0)
    for want_l, got_l in zip(caches, got):
        for name in ("k", "v"):
            want = want_l["kv"][name]
            back = got_l["kv"][name]
            assert back.dtype == want.dtype
            bound = want.abs().amax(dim=(-2, -1), keepdim=True) / 254 + 1e-6
            assert bool(((back - want).abs() <= bound).all())
    kv.release(0)
    assert not bool(kv.pool["k"].any())
    assert bool((kv.scales["k"] == 1.0).all())
    assert kv.alloc.free_count == kv.alloc.capacity
    assert not bool(kv.pool["v"][:, 0].any())
    with pytest.raises(ValueError, match="int8"):
        PagedKVCache(cfg, **mk, quantize="int4")


def test_kv_quantized_preempt_resume_bitwise_greedy(no_fault):
    greedy = _engine(temperature=0.0)
    roomy = _serve_all(greedy, _requests(8, seed=1), num_kv_blocks=12,
                       kv_quantize="int8")
    ref = {rid: r.tokens.copy() for rid, r in roomy.results.items()}
    assert _assert_conservation(roomy, 8)["preempted"] == 0
    health.clear_serve()
    tight = _serve_all(greedy, _requests(8, seed=1), num_kv_blocks=3,
                       kv_quantize="int8")
    s = _assert_conservation(tight, 8)
    assert s["completed"] == 8 and s["evicted"] == 0
    assert s["preempted"] >= 1 and s["resumed"] == s["preempted"]
    for rid, toks in ref.items():
        np.testing.assert_array_equal(tight.results[rid].tokens, toks)


def test_kv_quantized_preempt_resume_bitwise_sampled(engine, no_fault):
    ref = _undisturbed(engine, _requests(8, seed=1), num_kv_blocks=12,
                       kv_quantize="int8")
    tight = _serve_all(engine, _requests(8, seed=1), num_kv_blocks=3,
                       kv_quantize="int8")
    s = _assert_conservation(tight, 8)
    assert s["completed"] == 8 and s["evicted"] == 0
    assert s["preempted"] >= 1 and s["resumed"] == s["preempted"]
    for rid, toks in ref.items():
        np.testing.assert_array_equal(tight.results[rid].tokens, toks)


def _committed_bytes(engine, reqs, **kw):
    """Each request's committed int8 values and scales, read from its
    blocks when its row is released at completion."""
    cs, _ = _sched(engine, kv_quantize="int8", **kw)
    kv, seen = cs.kv, {}
    release = kv.release

    def snapshot(row):
        slot = cs._live.get(row)
        if slot is not None and kv._slot_blocks[row]:
            n = slot.req.tokens.shape[0] + len(slot.emitted) - 1
            idx = torch.as_tensor(kv._slot_blocks[row])
            seen[slot.req.request_id] = [
                (kv.pool[name][:, idx].flatten(1, 2)[:, :n].clone(),
                 kv.scales[name][:, idx].flatten(1, 2)[:, :n].clone())
                for name in ("k", "v")]
        release(row)
    kv.release = snapshot
    for r in reqs:
        cs.submit(r)
    cs.drain(max_ticks=20_000)
    stats = cs.stats()
    health.clear_serve()
    return stats, seen


def test_kv_quantized_resume_commits_each_position_once(no_fault):
    """Quantize exactly once: with a bf16 cache (where dequantize ->
    quantize again is not the identity), every request's committed int8
    values and scales after preempt / resume cycles equal, byte for byte,
    those of the uninterrupted run."""
    cfg = dataclasses.replace(reduced_config("olmo-1b"),
                              compute_dtype="float32")
    model = build(cfg, device="cpu")
    engine = Engine(model, model.init(0),
                    ServeConfig(max_len=32, temperature=0.7, seed=3,
                                cache_dtype="bfloat16"), device="cpu")
    _, want = _committed_bytes(engine, _requests(8, seed=1), num_kv_blocks=12)
    s, got = _committed_bytes(engine, _requests(8, seed=1), num_kv_blocks=3)
    assert s["preempted"] >= 1 and s["completed"] == 8
    assert got.keys() == want.keys()
    for rid in want:
        for (q1, s1), (q2, s2) in zip(want[rid], got[rid]):
            assert torch.equal(q1, q2) and torch.equal(s1, s2), rid


@pytest.mark.parametrize("fault_site,fault_nth", [
    (None, None), ("kv_alloc", 2), ("batch_step", 2), ("batch_step", (1, 2, 3))])
def test_kv_quantized_fault_conservation(engine, no_fault, fault_site,
                                         fault_nth):
    ref = _undisturbed(engine, _requests(6, seed=21), num_kv_blocks=12,
                       kv_quantize="int8")
    ctx = (faults.inject(fault_site, nth=fault_nth) if fault_site
           else _Null())
    with ctx:
        cs = _serve_all(engine, _requests(6, seed=21), num_kv_blocks=3,
                        kv_quantize="int8", max_retries=2 if fault_nth != (
                            1, 2, 3) else 1)
    s = _assert_conservation(cs, 6)
    guilty = 1 if fault_nth == (1, 2, 3) else 0
    assert s["completed"] == 6 - guilty and s["evicted"] == guilty
    if fault_site:
        assert s["retries"] >= 1
    for rid, res in cs.results.items():
        np.testing.assert_array_equal(res.tokens, ref[rid][:len(res.tokens)])
        if res.status == "completed":
            assert len(res.tokens) == len(ref[rid])


def _quant_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    x[0, 0] = 0.0                               # an all-zero position
    x[0, 1, 2, 3] = 7.5                         # its own absmax: +127
    x[1, 2, 0, 0] = -9.25                       # -127
    x[2, 3] = np.round(x[2, 3] * 4) / 4         # exact halves for rounding
    x[2, 4] = 1e-30                             # a tiny scale
    return x


def test_quantize_kv_position_matches_reference_bitwise():
    x = _quant_inputs()
    q_ref, s_ref = ref_quantize_kv_position(x)
    q, s = quantize_kv_position(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(s_ref).view(np.uint32))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q[0, 1, 2, 3]) == 127 and int(q[1, 2, 0, 0]) == -127
    assert float(s[0, 0]) == 1.0 and not bool(q[0, 0].any())


# ---------------------------------------------------------------------------
# Parity with the JAX package's scheduler (same numpy weights, temperature 0)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_pair():
    return engines(numpy_tree(0))


def _continuous_both(pair, *, site=None, nth=None, **kw):
    """Serve the same long-ish requests (prompts 8-16, budgets 4-12: a
    worst-case pool of 12 blocks) through both schedulers under a
    VirtualClock and the same armed fault."""
    out = []
    for eng, Cs, Cfg, Clock, Req, hmod, fmod in (
            (pair[0], RefContinuousScheduler, RefContinuousConfig,
             RefVirtualClock, RefRequest, ref_health, ref_faults),
            (pair[1], ContinuousScheduler, ContinuousConfig, VirtualClock,
             Request, health, faults)):
        hmod.clear_serve()
        clock = Clock()
        cs = Cs(eng, Cfg(**{"queue_capacity": 32, "max_live": 3,
                            "block_size": 8, **kw}),
                clock=clock, sleep=clock.sleep)
        with (fmod.inject(site, nth=nth) if site else _Null()):
            for r in requests(Req, 8, seed=31, lengths=(8, 12, 16),
                              budgets=(4, 8, 12)):
                cs.submit(r)
            cs.drain(max_ticks=20_000)
        out.append((lifecycle(eng.serve_report()), tokens_of(cs.results),
                    cs.stats()))
        hmod.clear_serve()
    return out


@pytest.mark.parametrize("blocks,site,nth,kw", [
    (None, None, None, {}),                 # worst case: 12 blocks
    (6, None, None, {}),                    # about half: preemption
    (6, "batch_step", (1, 2, 3), {"max_retries": 1}),
    (None, "batch_step", (1, 2), {"max_retries": 1}),
    (6, "kv_alloc", 3, {}),
    (6, "engine_step", 2, {}),
    (6, None, None, {"kv_quantize": "int8"}),
])
def test_scheduler_matches_reference(greedy_pair, no_fault, blocks, site, nth,
                                     kw):
    want, got = _continuous_both(greedy_pair, site=site, nth=nth,
                                 num_kv_blocks=blocks, **kw)
    assert got[2] == want[2]              # stats(): counters, depths, pool
    assert got[0] == want[0]              # statuses, retries, events
    assert got[1] == want[1]              # greedy tokens
    if blocks == 6 and site is None:
        assert got[2]["preempted"] >= 1
    if nth == (1, 2, 3):
        assert got[0]["events"].get("bisect:guilty") == 1
