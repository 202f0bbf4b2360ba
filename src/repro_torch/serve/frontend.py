"""Resilient request-stream front end over the Engine's per-request step API.

The request-lifecycle layer the continuous-batching scheduler sits on
(``serve/scheduler.py`` — the same contract, one shared batched decode step
over a paged KV pool instead of batch-1 slots). This front end is the
batch-1 implementation: every request decodes in its own batch-1 slot.

Request-lifecycle contract
==========================

States: ``queued -> live -> {completed | evicted | deadline_miss}``, plus
``shed`` straight from admission. Exactly one terminal state per offered
request — the CONSERVATION invariant ``offered == admitted + shed`` and
``admitted == completed + evicted + deadline_miss + open`` is tracked by
monotonic counters in the process-global ``repro_torch.core.health.SERVE``
registry and surfaced through ``Engine.serve_report()``.

* **Admission / backpressure**: a bounded FIFO queue (``queue_capacity``).
  The shedding policy is REJECT-NEWEST: when the queue is full (or the
  admission path itself fails — fault site ``admission``), ``submit``
  returns the typed :class:`~repro_torch.serve.requests.Overloaded` result
  and records the shed. Queued / live requests are never displaced;
  nothing is ever silently dropped.
* **Deadlines / budgets**: enforced at STEP granularity. Each request
  carries a token budget (``max_new_tokens``) and an optional wall-clock
  ``deadline_s`` measured from admission (queue wait included); a live
  request past its deadline finalizes as ``deadline_miss`` with its
  partial tokens.
* **Retry with capped backoff**: a step failure (fault site
  ``engine_step``, or any exception from the step) is classified by
  ``health.classify_failure``; classes ``compile`` / ``resource`` /
  ``runtime`` are retried up to ``max_retries`` per step with exponential
  backoff capped at ``backoff_cap_s``. A retried step recomputes the same
  position from the same inputs, and sampling is seeded per (request_id,
  step), so a retry recomputes the identical token. Exhausted retries
  evict.
* **Per-request fault isolation**: ``numerics``-class failures (NaN logits
  under ``REPRO_NUMERICS_GUARD=1`` — fault site ``sample`` injects the
  corruption) evict the ONE failing request immediately, no retry. Every
  request runs in its own batch-1 slot with its own caches and its own
  sampling seeds, so the surviving requests' outputs are BITWISE identical
  to an undisturbed run.

The host loop is single-threaded; the lifecycle registry it records into
is thread-safe and bounded (ring + dropped-records counter).

This module is the port's copy of the JAX package's ``serve/frontend.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import health
from repro_torch.serve import graphs
from repro_torch.serve.requests import Overloaded, Request, RequestResult
from repro_torch.testing import faults

# Failure classes the step-retry loop retries (transient-shaped); everything
# else — numerics, unsupported, io — evicts immediately.
RETRYABLE_CLASSES = ("compile", "resource", "runtime")


@dataclasses.dataclass
class StreamConfig:
    queue_capacity: int = 16       # bounded admission queue (backpressure)
    max_live: int = 4              # concurrent batch-1 decode slots
    max_retries: int = 2           # per-step retry budget (retryable classes)
    backoff_base_s: float = 0.005  # first retry's backoff
    backoff_cap_s: float = 0.08    # exponential backoff cap
    default_max_new_tokens: int = 16
    default_deadline_s: Optional[float] = None  # None = no deadline


class VirtualClock:
    """Deterministic clock for tests/benches: ``clock()`` reads simulated
    time, ``sleep(dt)`` advances it. Passing one instance as both the
    front-end's ``clock`` and ``sleep`` makes admission order, deadlines,
    backoff, and latency percentiles machine-independent."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(0.0, float(dt))


@dataclasses.dataclass
class _Slot:
    """One live request's serving state (a batch-1 decode slot)."""

    req: Request
    budget: int
    deadline_s: Optional[float]
    admit_t: float
    caches: object = None          # None until prefill succeeds
    last_tok: object = None        # tensor [1, 1]
    emitted: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0


class StreamFrontend:
    """Admission control + deadlines + retry/shedding + fault isolation on
    top of one :class:`~repro.serve.engine.Engine` (see module docstring).

    ``clock``/``sleep`` are injectable (default wall clock) — pass a
    :class:`VirtualClock` for deterministic scheduling in tests/benches.
    """

    def __init__(self, engine, cfg: StreamConfig = StreamConfig(), *,
                 clock=time.monotonic, sleep=time.sleep):
        self.engine = engine
        self.cfg = cfg
        self._clock = clock
        self._sleep = sleep
        self._queue: collections.deque = collections.deque()  # (req, admit_t)
        self._live: Dict[int, _Slot] = {}
        self.results: Dict[int, RequestResult] = {}
        self._seen: set = set()

    # ----- admission ------------------------------------------------------

    def submit(self, request: Request) -> Optional[Overloaded]:
        """Offer one request. Returns None when ADMITTED (the result will
        arrive from ``step``/``drain``/``run``), or the typed
        :class:`Overloaded` result when shed — never raises for load."""
        rid = request.request_id
        if rid in self._seen:
            raise ValueError(f"duplicate request_id {rid}")
        self._seen.add(rid)
        try:
            faults.maybe_fail("admission")
        except Exception as exc:  # noqa: BLE001 — classified, recorded, typed
            cause = health.classify_failure(exc)
            return self._shed(request, f"admission failure ({cause}): {exc}")
        if len(self._queue) >= self.cfg.queue_capacity:
            return self._shed(
                request, f"queue full (capacity {self.cfg.queue_capacity})")
        health.SERVE.admitted(rid)
        self._queue.append((request, self._clock()))
        return None

    def _shed(self, request: Request, detail: str) -> Overloaded:
        health.SERVE.shed(request.request_id, detail)
        result = Overloaded(
            request_id=request.request_id, status="shed",
            tokens=np.zeros((0,), np.int32), detail=detail,
            queue_depth=len(self._queue))
        self.results[request.request_id] = result
        return result

    # ----- stepping -------------------------------------------------------

    def step(self) -> Dict[int, RequestResult]:
        """One scheduler tick: fill free slots from the queue, then advance
        every live request by one token. Returns newly finalized results."""
        done: Dict[int, RequestResult] = {}
        while self._queue and len(self._live) < self.cfg.max_live:
            req, admit_t = self._queue.popleft()
            budget = req.max_new_tokens or self.cfg.default_max_new_tokens
            deadline = (req.deadline_s if req.deadline_s is not None
                        else self.cfg.default_deadline_s)
            self._live[req.request_id] = _Slot(
                req=req, budget=budget, deadline_s=deadline, admit_t=admit_t)
            health.SERVE.live(req.request_id)
        now = self._clock()
        for rid in list(self._live):
            slot = self._live[rid]
            if slot.deadline_s is not None \
                    and now - slot.admit_t > slot.deadline_s:
                done[rid] = self._finalize(
                    slot, "deadline_miss",
                    f"deadline {slot.deadline_s:.3f}s elapsed")
                continue
            result = self._step_slot(slot)
            if result is not None:
                done[rid] = result
        return done

    def _step_slot(self, slot: _Slot) -> Optional[RequestResult]:
        """Advance one request by one token, with classified retry."""
        rid = slot.req.request_id
        step_idx = len(slot.emitted)
        attempts = 0
        while True:
            try:
                faults.maybe_fail("engine_step")
                if slot.caches is None:
                    logits, caches = self.engine.prefill_request(
                        slot.req.tokens)
                else:
                    pos = slot.req.tokens.shape[0] + step_idx - 1
                    raw, caches = self.engine.decode_request(
                        slot.caches, slot.last_tok, pos)
                    logits = raw[:, 0]
                logits = faults.corrupt("sample", logits)
                if health.numerics_guard_enabled() \
                        and health.has_nonfinite(logits):
                    raise health.NumericsError(
                        f"non-finite logits for request {rid} "
                        f"at step {step_idx}")
            except Exception as exc:  # noqa: BLE001 — classify, retry/evict
                cause = health.classify_failure(exc)
                if cause in RETRYABLE_CLASSES \
                        and attempts < self.cfg.max_retries:
                    attempts += 1
                    backoff = min(
                        self.cfg.backoff_base_s * (2 ** (attempts - 1)),
                        self.cfg.backoff_cap_s)
                    health.SERVE.retry(rid, step_idx, cause, backoff)
                    slot.retries += 1
                    self._sleep(backoff)
                    continue
                return self._finalize(slot, "evicted",
                                      f"{cause}: {exc}")
            break
        # Commit only after a fully clean step: a retried or evicted step
        # leaves the slot as it was. The prefill's caches are the slot's to
        # keep. A decode step through the engine's graphs ran on the graph's
        # static caches, which the next request's step overwrites: they are
        # copied back into the slot's own here. The eager decode writes
        # position ``pos`` into the slot's caches in place (only a
        # functional leaf, an SSM state, is copied back), before a later
        # failure of the same step (the ``sample`` corruption) can happen;
        # a retry writes the same value to the same position before it
        # reads it, and an eviction drops the caches, so both stay bitwise.
        tok = self.engine.sample_tokens(logits, [rid], step_idx)
        if slot.caches is None:
            slot.caches = caches
        else:
            graphs.copy_back(slot.caches, caches)
        slot.last_tok = tok[:, None]
        slot.emitted.append(int(tok[0]))
        if len(slot.emitted) >= slot.budget:
            return self._finalize(slot, "completed")
        return None

    def _finalize(self, slot: _Slot, status: str,
                  detail: str = "") -> RequestResult:
        rid = slot.req.request_id
        latency = self._clock() - slot.admit_t
        health.SERVE.finalize(rid, status, step=len(slot.emitted),
                              tokens_emitted=len(slot.emitted),
                              latency_s=latency, detail=detail)
        result = RequestResult(
            request_id=rid, status=status,
            tokens=np.asarray(slot.emitted, np.int32), detail=detail,
            retries=slot.retries, latency_s=latency)
        self.results[rid] = result
        self._live.pop(rid, None)
        return result

    # ----- driving loops --------------------------------------------------

    def drain(self, max_ticks: int = 1_000_000) -> Dict[int, RequestResult]:
        """Step until every admitted request reaches a terminal state."""
        done: Dict[int, RequestResult] = {}
        ticks = 0
        while self._queue or self._live:
            done.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("drain exceeded max_ticks — a request "
                                   "is not making progress")
        return done

    def run(self, schedule: Iterable[Tuple[float, Request]],
            tick_s: float = 0.0) -> Dict[int, RequestResult]:
        """Serve a timed arrival schedule ``[(arrival_s, request), ...]``
        (relative to the first call of ``clock``). Arrivals are offered
        when the clock passes them; ``tick_s`` > 0 charges each scheduler
        tick that amount of (virtual or real) time. Returns every offered
        request's terminal result."""
        sched = sorted(schedule, key=lambda it: it[0])
        results: Dict[int, RequestResult] = {}
        t0 = self._clock()
        i = 0
        while i < len(sched) or self._queue or self._live:
            now = self._clock() - t0
            while i < len(sched) and sched[i][0] <= now:
                req = sched[i][1]
                i += 1
                res = self.submit(req)
                if res is not None:
                    results[req.request_id] = res
            if not self._queue and not self._live:
                if i < len(sched):   # idle: wait for the next arrival
                    self._sleep(max(sched[i][0] - now, 1e-9))
                continue
            results.update(self.step())
            if tick_s:
                self._sleep(tick_s)
        return results

    # ----- observability --------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Queue/slot depths + the registry's conservation counters."""
        stats = dict(health.SERVE.counters())
        stats["queued"] = len(self._queue)
        stats["live"] = len(self._live)
        return stats
