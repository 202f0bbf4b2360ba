"""Deterministic fault injection for the port's guarded contraction stack,
its serving stack and its checkpoints.

Production code is instrumented with *named sites* — cheap probes that do
nothing until the ``REPRO_FAULT`` environment variable arms exactly one of
them:

    REPRO_FAULT=<site>            every hit of <site> fails
    REPRO_FAULT=<site>:<nth>      only the <nth> hit (1-based) fails
    REPRO_FAULT=<site>:<n1>,<n2>  exactly the listed hits fail

The multi-hit form exists for the continuous-batching scheduler's bisection
contract: one armed ``batch_step`` site must be able to fail the SHARED
batched step (hit #1) and then exactly one per-row bisection re-run (a
later hit), so a single ``REPRO_FAULT`` value stages "batched step poisoned
by one request" deterministically.

Two probe flavours:

  * :func:`maybe_fail` — control-flow faults: raises :class:`InjectedFault`
    (or the OSError-compatible :class:`InjectedIOError` for the checkpoint
    I/O sites) carrying the site's declared failure class, so
    ``repro_torch.core.health.classify_failure`` classifies it exactly like
    the real failure it stands in for.
  * :func:`corrupt` — data faults: returns the operand poisoned with NaN.

The grammar, the site names and their classes are the JAX package's. This
module's hit counters are its own state: the two packages share only the
environment variable, so arming a site arms it in both, and each counts
its own hits. An unknown site name in ``REPRO_FAULT`` is a hard error (a
typo must not silently disarm a fault matrix).

Determinism: hit counters are process-global and increase monotonically
per site; :func:`reset` (or the :class:`inject` context manager tests use)
zeroes them so that every test sees hit #1 first. An eager call fires a
probe once per call of the code around it; a captured served step
(``repro_torch.serve.graphs``) fires the probes of its body in its warm-up
and capture passes only, never on a replay.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

ENV_FAULT = "REPRO_FAULT"

# site name -> the failure class it stands in for (see
# repro_torch.core.health.FAILURE_CLASSES; "io" is checkpoint-only).
FAULT_SITES = {
    "pack": "resource",            # tile-major pack buffer materialization
    "kernel_compile": "compile",   # kernel build stage
    "kernel_run": "runtime",       # kernel execution stage
    "scale_grid": "numerics",      # quantized-weight scale grid (corruption)
    "checkpoint_save": "io",       # mid-save crash
    "checkpoint_read": "io",       # transient restore read failure
    # Serving front-end sites (serve/frontend.py), once per request step /
    # admission attempt:
    "engine_step": "runtime",      # one prefill/decode step of one request
    "sample": "numerics",          # logits corruption before sampling (NaN)
    "admission": "resource",       # admission-path failure (shed, not drop)
    # Continuous-batching sites (serve/scheduler.py + serve/kv_cache.py).
    # kv_alloc fires inside BlockAllocator.try_alloc (one hit per allocation
    # attempt); batch_step fires once per SHARED batched decode attempt AND
    # once per per-row bisection re-run:
    "kv_alloc": "resource",        # paged-KV block allocation (backpressure)
    "batch_step": "runtime",       # one shared batched decode step / re-run
    # Bench/launch harness site: one harness job attempt.
    "harness_job": "runtime",
}

_IO_SITES = frozenset({"checkpoint_save", "checkpoint_read"})

_hits: dict = {}


class InjectedFault(Exception):
    """A deterministic injected failure; carries the site's failure class so
    ``repro_torch.core.health.classify_failure`` needs no message parsing."""

    def __init__(self, site: str, hit: int, failure_class: str):
        self.site = site
        self.hit = hit
        self.failure_class = failure_class
        super().__init__(f"injected fault at site {site!r} "
                         f"(hit #{hit}, class {failure_class!r})")


class InjectedIOError(InjectedFault, OSError):
    """Injected fault for the I/O sites — an OSError, so retry loops built
    for real transient I/O failures exercise their actual except clause."""


def _check_site(site: str) -> None:
    if site not in FAULT_SITES:
        raise ValueError(f"unknown fault site {site!r}; "
                         f"one of {sorted(FAULT_SITES)}")


def active() -> Tuple[Optional[str], Optional[object]]:
    """The armed ``(site, nth)`` from ``REPRO_FAULT`` (None, None if unset).
    ``nth`` is None for the fail-every-hit form, an int for a single hit,
    or a tuple of ints for the multi-hit form (``site:n1,n2``)."""
    env = os.environ.get(ENV_FAULT)
    if not env:
        return None, None
    site, _, nth = env.partition(":")
    _check_site(site)
    if not nth:
        return site, None
    hits_ = tuple(int(p) for p in nth.split(","))
    return site, (hits_[0] if len(hits_) == 1 else hits_)


def hits(site: str) -> int:
    """How many times the armed site has been reached (0 when disarmed —
    counters only advance while their site is armed)."""
    _check_site(site)
    return _hits.get(site, 0)


def reset() -> None:
    """Zero all hit counters (per-test isolation)."""
    _hits.clear()


def _armed_hit(site: str) -> Optional[bool]:
    """None if this site is not armed; else whether this hit should fire."""
    armed, nth = active()
    if armed != site:
        return None
    _hits[site] = hit = _hits.get(site, 0) + 1
    if nth is None:
        return True
    return hit in nth if isinstance(nth, tuple) else hit == nth


def maybe_fail(site: str) -> None:
    """Raise the site's injected fault if armed for this hit; else no-op."""
    _check_site(site)
    if _armed_hit(site):
        cls = InjectedIOError if site in _IO_SITES else InjectedFault
        raise cls(site, _hits[site], FAULT_SITES[site])


def corrupt(site: str, x):
    """Data-fault probe: ``x`` NaN-poisoned (a tensor of its shape, dtype
    and device) if the site is armed for this hit, else ``x`` unchanged.
    ``None`` passes through uncounted (an absent optional operand cannot be
    corrupted)."""
    _check_site(site)
    if x is None:
        return None
    if _armed_hit(site):
        if torch.is_tensor(x):
            return torch.full_like(x, float("nan"))
        return np.full_like(x, np.nan)
    return x


class inject:
    """Context manager arming one site for the enclosed block (test sugar):

        with faults.inject("engine_step", nth=1):
            frontend.drain()    # the first step attempt fails

    Sets / restores ``REPRO_FAULT`` and resets the hit counters on both
    entry and exit, so consecutive uses are independent.
    """

    def __init__(self, site: str, nth=None):
        _check_site(site)
        if nth is None:
            self._value = site
        elif isinstance(nth, (tuple, list)):
            self._value = f"{site}:{','.join(str(n) for n in nth)}"
        else:
            self._value = f"{site}:{nth}"
        self._saved: Optional[str] = None

    def __enter__(self):
        self._saved = os.environ.get(ENV_FAULT)
        os.environ[ENV_FAULT] = self._value
        reset()
        return self

    def __exit__(self, *exc):
        if self._saved is None:
            os.environ.pop(ENV_FAULT, None)
        else:
            os.environ[ENV_FAULT] = self._saved
        reset()
        return False
