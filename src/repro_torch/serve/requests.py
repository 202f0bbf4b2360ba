"""Request-stream vocabulary for the serving front end.

A :class:`Request` is one user's generation job: a token prompt plus its
budget (``max_new_tokens``) and an optional wall-clock ``deadline_s``
measured from ADMISSION. Every offered request ends in exactly one
:class:`RequestResult` whose ``status`` is a terminal lifecycle state
(``repro_torch.core.health.TERMINAL_STATES``):

  * ``completed``     the full token budget was generated;
  * ``shed``          rejected at admission (bounded queue full, or the
                      admission path itself failed) — the result is the
                      typed :class:`Overloaded` subclass, never a silent
                      drop;
  * ``evicted``       a step failed non-retryably (numerics-class NaN
                      logits under ``REPRO_NUMERICS_GUARD``, or a
                      retryable class with the retry budget exhausted);
                      tokens generated before the fault are returned;
  * ``deadline_miss`` the deadline elapsed mid-stream; partial tokens are
                      returned.

Under the continuous-batching scheduler (``serve.scheduler``) a live
request may also pass through the TRANSIENT ``preempted`` state — bumped
back to the queue under KV-block backpressure and later resumed with a
bitwise-identical token stream; ``RequestResult.preemptions`` counts how
many times that happened. Preemption is never terminal and never loses
tokens.

The conservation invariant over these states — every offered request
reaches exactly one of them, no losses, no duplicates — is tracked by the
process-global ``repro_torch.core.health.SERVE`` registry and surfaced
through ``Engine.serve_report()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.health import REQUEST_STATES, TERMINAL_STATES  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request offered to the stream front end.

    ``request_id`` is the caller's identity for the request AND a value
    the engine keys the request's sampled draws with
    (``Engine.sample_tokens``): a request's token stream depends only on
    (params, prompt, request_id), never on its batch neighbours.
    """

    request_id: int
    tokens: np.ndarray                      # [S] int32 prompt tokens
    max_new_tokens: Optional[int] = None    # None -> front-end default
    deadline_s: Optional[float] = None      # from admission; None = no limit

    def __post_init__(self):
        toks = np.asarray(self.tokens, np.int32)
        if toks.ndim != 1 or toks.size == 0:
            raise ValueError("Request.tokens must be a non-empty [S] vector")
        object.__setattr__(self, "tokens", toks)


@dataclasses.dataclass
class RequestResult:
    """Terminal outcome of one request (see the module docstring)."""

    request_id: int
    status: str                   # terminal state from TERMINAL_STATES
    tokens: np.ndarray            # [n_emitted] generated tokens (may be 0)
    detail: str = ""              # cause for evicted/shed/deadline_miss
    retries: int = 0              # failed step attempts that were retried
    latency_s: float = 0.0        # admission -> terminal
    preemptions: int = 0          # KV-backpressure preempt/resume cycles

    def __post_init__(self):
        if self.status not in TERMINAL_STATES:
            raise ValueError(f"non-terminal result status {self.status!r}")

    @property
    def ok(self) -> bool:
        return self.status == "completed"


@dataclasses.dataclass
class Overloaded(RequestResult):
    """The TYPED load-shedding result: admission rejected this request
    (reject-newest policy — queued / live requests are never displaced).
    ``queue_depth`` is the admission queue's depth at rejection time."""

    queue_depth: int = 0

    def __post_init__(self):
        self.status = "shed"
        super().__post_init__()
