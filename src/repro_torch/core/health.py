"""Health registries: guarded-dispatch degradations AND every serving
request's lifecycle, recorded in bounded thread-safe process-global
registries (``HEALTH`` for dispatch, ``SERVE`` for requests).

``HEALTH`` holds one row per ``(spec, lowering)``: how often it failed, the
classified cause, the fallback that took over, and the last failure's
detail string. ``Engine.health_report()`` reads it. The guarded runner
(``repro_torch.core.contraction.run_guarded``) writes a row each time an
env / auto contraction on the CPU degrades down its fallback chain (on the
card the chain is the winner alone, whose failure raises); the serving
stack records its own typed rows (the scheduler's ``kv_leak``).

Failure classes (:data:`FAILURE_CLASSES`):

  * ``compile``      kernel build / lowering errors
  * ``resource``     memory budget overflows (out of memory, pool
                     exhaustion standing in for them)
  * ``unsupported``  backend / feature not supported by the lowering
  * ``numerics``     NaN/Inf in the output (opt-in: ``REPRO_NUMERICS_GUARD``)
  * ``runtime``      everything else (kernel execution failures)

:func:`classify_failure` maps an exception to a class: an exception that
declares ``failure_class`` (injected faults, :class:`NumericsError`) wins;
otherwise the type / message is matched. The numerics guard is opt-in
because it reads the value back (a synchronization on the card), and it
reads nothing while a CUDA graph is captured (:func:`numerics_guard_active`).

This module is the port's copy of the JAX package's ``core/health.py``:
the same classes, states, events, counters and reports.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Tuple

import numpy as np
import torch

FAILURE_CLASSES = ("compile", "resource", "unsupported", "numerics",
                   "runtime")

ENV_NUMERICS_GUARD = "REPRO_NUMERICS_GUARD"


class NumericsError(FloatingPointError):
    """Non-finite values in a contraction output under the numerics guard.
    Raised (never degraded) for explicit ``strategy=`` choices."""

    failure_class = "numerics"


def numerics_guard_enabled() -> bool:
    """Opt-in NaN/Inf output guard (``REPRO_NUMERICS_GUARD=1``)."""
    return os.environ.get(ENV_NUMERICS_GUARD, "").lower() in (
        "1", "true", "on", "yes")


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False with no
    CUDA in this torch)."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:  # torch built without CUDA
        return False


def numerics_guard_active() -> bool:
    """The numerics guard armed and free to read back: never while a CUDA
    graph is being captured, where a read-back is illegal. The reference's
    guard is eager-only too: a jit'd step decides at trace time
    (``serve.graphs``: the warm-up step before a capture still checks)."""
    return numerics_guard_enabled() and not capturing()


def has_nonfinite(out) -> bool:
    """True when ``out`` (a tensor, or anything numpy takes) holds NaN or
    Inf. The check reads the value back, so on the card it synchronizes."""
    if torch.is_tensor(out):
        return not bool(torch.isfinite(out).all())
    return not bool(np.all(np.isfinite(np.asarray(out, np.float32))))


def classify_failure(exc: BaseException) -> str:
    """Map an exception from a lowering's run to a failure class."""
    declared = getattr(exc, "failure_class", None)
    if declared in FAILURE_CLASSES:
        return declared
    msg = str(exc).lower()
    if isinstance(exc, MemoryError) or "resource_exhausted" in msg \
            or "vmem" in msg or "out of memory" in msg:
        return "resource"
    if isinstance(exc, NotImplementedError) or "unsupported" in msg \
            or "not supported" in msg or "not implemented" in msg:
        return "unsupported"
    if "mosaic" in msg or "compil" in msg or "lowering" in msg \
            or "nvcc" in msg or "ptxas" in msg:
        return "compile"
    return "runtime"


@dataclasses.dataclass
class DegradationRecord:
    """One (spec, lowering) row of the health registry."""

    spec: str        # ContractionSpec.describe() of the degraded contraction
    lowering: str    # the lowering that failed
    cause: str       # classified failure class of the LAST failure
    fallback: str    # the lowering the runner degraded to (last)
    detail: str = ""  # last failure's "ExcType: message" (or guard note)
    count: int = 1   # how many times this (spec, lowering) degraded


class HealthRegistry:
    """Thread-safe, BOUNDED per-(spec, lowering) degradation counters.

    A long-lived serving process degrades and recovers for the whole life of
    the deployment; the registry therefore keeps at most ``max_records``
    distinct (spec, lowering) rows as a ring — when a new row would exceed
    the bound the OLDEST row is dropped and counted in :attr:`dropped`, so
    monitoring can tell "empty because healthy" from "empty because
    evicted". Counters on surviving rows are unaffected by the bound.
    """

    def __init__(self, max_records: int = 1024):
        self._records: Dict[Tuple[str, str], DegradationRecord] = {}
        self._lock = threading.Lock()
        self._max_records = max(1, int(max_records))
        self._dropped = 0

    def record(self, spec: str, lowering: str, cause: str, fallback: str,
               detail: str = "") -> None:
        with self._lock:
            rec = self._records.get((spec, lowering))
            if rec is None:
                while len(self._records) >= self._max_records:
                    self._records.pop(next(iter(self._records)))
                    self._dropped += 1
                self._records[(spec, lowering)] = DegradationRecord(
                    spec=spec, lowering=lowering, cause=cause,
                    fallback=fallback, detail=detail)
            else:
                rec.count += 1
                rec.cause = cause
                rec.fallback = fallback
                rec.detail = detail

    @property
    def dropped(self) -> int:
        """Rows evicted by the ring bound (0 == nothing ever dropped)."""
        with self._lock:
            return self._dropped

    def records(self) -> Tuple[DegradationRecord, ...]:
        with self._lock:
            return tuple(dataclasses.replace(r)
                         for r in self._records.values())

    def report(self) -> Dict[str, dict]:
        """``{"<spec> -> <lowering>": {count, cause, fallback, detail}}`` —
        plain dicts, JSON-serializable (monitoring export)."""
        with self._lock:
            return {f"{r.spec} -> {r.lowering}": {
                "count": r.count, "cause": r.cause,
                "fallback": r.fallback, "detail": r.detail,
            } for r in self._records.values()}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __bool__(self) -> bool:
        return len(self) > 0


# The process-global registry the guarded runner records into and
# Engine.health_report() reads from.
HEALTH = HealthRegistry()


def record_degradation(spec: str, lowering: str, cause: str, fallback: str,
                       detail: str = "") -> None:
    HEALTH.record(spec, lowering, cause, fallback, detail)


def health_report() -> Dict[str, dict]:
    return HEALTH.report()


def clear_health() -> None:
    HEALTH.clear()


# ---------------------------------------------------------------------------
# Request-lifecycle records (the serving front-end's side of the registry)
# ---------------------------------------------------------------------------

# Lifecycle states a request can be in. Terminal states are exactly the four
# ways an offered request may END — the request-conservation invariant the
# serving front-end maintains is
#     offered == admitted + shed
#     admitted == completed + evicted + deadline_miss
#                 + open + preempted_open
# with every admitted request reaching exactly ONE terminal state. ``open``
# is the in-flight population (queued or live, never preempted so far);
# ``preempted_open`` the TRANSIENT preempted population — requests the
# continuous-batching scheduler pushed back to the queue under KV-block
# backpressure and has not yet resumed. Both drain to zero at quiescence,
# closing the invariant to the original four-terminal form.
REQUEST_STATES = ("queued", "live", "preempted", "completed", "evicted",
                  "deadline_miss", "shed")
TERMINAL_STATES = frozenset({"completed", "evicted", "deadline_miss", "shed"})

# Lifecycle events the serving layers record (shed covers both queue
# overflow and admission-path failures; retry is per failed step attempt;
# preempted/resumed bracket a KV-backpressure preemption; bisect is one
# per-slot batch-1 re-run verdict of the continuous scheduler's
# blast-radius containment).
REQUEST_EVENTS = ("admitted", "shed", "retry", "preempted", "resumed",
                  "bisect", "evicted", "deadline_miss", "completed")


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle row: state + every recorded event."""

    request_id: int
    status: str                       # one of REQUEST_STATES
    events: list = dataclasses.field(default_factory=list)
    retries: int = 0                  # step attempts that failed retryably
    tokens_emitted: int = 0
    latency_s: float = 0.0            # admission -> terminal (terminal only)

    def as_dict(self) -> dict:
        return {"status": self.status, "retries": self.retries,
                "tokens_emitted": self.tokens_emitted,
                "latency_s": self.latency_s,
                "events": [dict(e) for e in self.events]}


class ServeRegistry:
    """Thread-safe, BOUNDED per-request lifecycle records + monotonic
    conservation counters.

    Records are a ring: at most ``max_records`` requests are retained
    (oldest TERMINAL rows evicted first — an in-flight request's row is
    never dropped while any finished row remains), with the evictions
    counted in :attr:`dropped`. The counters are monotonic and unaffected
    by the ring, so the conservation invariant (see REQUEST_STATES) is
    checkable over an arbitrarily long serving life.
    """

    def __init__(self, max_records: int = 1024):
        self._records: Dict[int, RequestRecord] = {}
        self._lock = threading.Lock()
        self._max_records = max(1, int(max_records))
        self._dropped = 0
        self._counters = {"offered": 0, "admitted": 0, "shed": 0,
                          "completed": 0, "evicted": 0, "deadline_miss": 0,
                          "retries": 0, "preempted": 0, "resumed": 0}

    def _insert(self, request_id: int) -> RequestRecord:
        # under self._lock
        rec = self._records.get(request_id)
        if rec is not None:
            return rec
        while len(self._records) >= self._max_records:
            victim = next(
                (k for k, r in self._records.items()
                 if r.status in TERMINAL_STATES),
                next(iter(self._records)))
            self._records.pop(victim)
            self._dropped += 1
        rec = self._records[request_id] = RequestRecord(
            request_id=request_id, status="queued")
        return rec

    def admitted(self, request_id: int, step: int = 0,
                 detail: str = "") -> None:
        with self._lock:
            self._counters["offered"] += 1
            self._counters["admitted"] += 1
            rec = self._insert(request_id)
            rec.status = "queued"
            rec.events.append({"event": "admitted", "step": step,
                               "detail": detail})

    def shed(self, request_id: int, detail: str = "") -> None:
        """An offered request REJECTED at admission (typed Overloaded) —
        terminal immediately, never silently dropped."""
        with self._lock:
            self._counters["offered"] += 1
            self._counters["shed"] += 1
            rec = self._insert(request_id)
            rec.status = "shed"
            rec.events.append({"event": "shed", "step": 0, "detail": detail})

    def live(self, request_id: int) -> None:
        with self._lock:
            rec = self._records.get(request_id)
            if rec is not None:
                rec.status = "live"

    def retry(self, request_id: int, step: int, cause: str,
              backoff_s: float) -> None:
        with self._lock:
            self._counters["retries"] += 1
            rec = self._records.get(request_id)
            if rec is not None:
                rec.retries += 1
                rec.events.append({"event": "retry", "step": step,
                                   "detail": cause,
                                   "backoff_s": backoff_s})

    def preempted(self, request_id: int, step: int, detail: str = "") -> None:
        """A LIVE request pushed back to the queue under KV-block
        backpressure (transient ``preempted`` state, never terminal)."""
        with self._lock:
            self._counters["preempted"] += 1
            rec = self._records.get(request_id)
            if rec is not None:
                rec.status = "preempted"
                rec.events.append({"event": "preempted", "step": step,
                                   "detail": detail})

    def resumed(self, request_id: int, step: int, detail: str = "") -> None:
        """A preempted request re-admitted to a decode slot (its prompt +
        generated prefix re-prefilled; the stream continues bitwise)."""
        with self._lock:
            self._counters["resumed"] += 1
            rec = self._records.get(request_id)
            if rec is not None:
                rec.status = "live"
                rec.events.append({"event": "resumed", "step": step,
                                   "detail": detail})

    def bisect(self, request_id: int, step: int, verdict: str,
               detail: str = "") -> None:
        """One per-slot batch-1 re-run verdict during blast-radius bisection
        of a failed batched step (``verdict``: exonerated / guilty)."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is not None:
                rec.events.append({"event": "bisect", "step": step,
                                   "detail": f"{verdict}: {detail}"
                                             if detail else verdict})

    def finalize(self, request_id: int, status: str, step: int,
                 tokens_emitted: int, latency_s: float,
                 detail: str = "") -> None:
        """Move an ADMITTED request to its one terminal state
        (completed / evicted / deadline_miss)."""
        assert status in TERMINAL_STATES and status != "shed", status
        with self._lock:
            self._counters[status] += 1
            rec = self._records.get(request_id)
            if rec is not None:
                rec.status = status
                rec.tokens_emitted = tokens_emitted
                rec.latency_s = latency_s
                rec.events.append({"event": status, "step": step,
                                   "detail": detail})

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def open_requests(self) -> int:
        """Retained records not yet terminal (queued or live)."""
        with self._lock:
            return sum(1 for r in self._records.values()
                       if r.status not in TERMINAL_STATES)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def report(self) -> Dict[str, dict]:
        """JSON-serializable lifecycle report (monitoring export)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "dropped_records": self._dropped,
                "requests": {str(r.request_id): r.as_dict()
                             for r in self._records.values()},
            }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0
            for k in self._counters:
                self._counters[k] = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


# The process-global request registry the serving front-end records into and
# Engine.serve_report() reads from (same pattern as HEALTH above).
SERVE = ServeRegistry()


def serve_report() -> Dict[str, dict]:
    """Request-lifecycle report + the dispatch registry's bound stats."""
    report = SERVE.report()
    report["dispatch_health"] = {"records": len(HEALTH),
                                 "dropped_records": HEALTH.dropped}
    return report


def clear_serve() -> None:
    SERVE.clear()
