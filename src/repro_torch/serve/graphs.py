"""Captured steps: the port's counterpart of ``jax.jit`` over a served or
trained step. The reference never runs such a step eagerly: its
``Engine`` jits prefill, decode, the argmax and the sampled draw
(``src/repro/serve/engine.py:166-183``), its continuous scheduler
compiles the batched step once (``src/repro/serve/scheduler.py``
``_build_step``) and its launcher jits the train step
(``src/repro/launch/train.py:123``). On the card the port captures the
engine's prefill, decode and draw, the scheduler's batched step and the
train step (``train.loop.TrainStep``, a :class:`StepGraph` with
``grad=True``) into CUDA graphs with :class:`StepGraph`.

**The static tree.** A step is ``body(static) -> outputs`` over a dict of
tensors (nested dicts and lists allowed) whose addresses are fixed for the
graph's life: the token, ``pos``, the caches or the pool's block tables.
Each call copies its inputs into their static leaves (:func:`copy_in`),
never rebinding one: the kernels' tensor maps are encoded on the host at
capture and hold those addresses. A decode that returns a new leaf instead
of writing in place (an SSM layer's state) has it copied back into its
static slot by the body itself (:func:`copy_back`), so the copy is part of
the graph.

**Capture.** On the card a graph's first call runs the body once eagerly
on the capture stream: that warm-up is the call's own step. It builds the
kernels, makes each kernel's first ``cudaFuncSetAttribute`` call and fires
any armed fault site. The second call captures the body into a
``torch.cuda.CUDAGraph`` and replays it, and every later call replays it:
a step seen once (a prompt length served once) costs one eager step and
no capture. Every graph warms up and captures on one side stream a device
(:func:`capture_stream`). An exception in the warm-up or the capture
discards the graph, ends the capture and propagates as it was raised
(with the note that names a failing contraction's spec); the next call
warms up again after a failed warm-up, captures again after a failed
capture. Nothing falls back to the eager path: a family whose decode
cannot be captured is named in :data:`EAGER_FAMILIES` with its reason, and
runs eagerly by that entry only.

**What runs once.** A replay runs no Python. Dispatch, the guarded runner,
the environment reads (``REPRO_FAULT``, ``REPRO_NUMERICS_GUARD``,
``REPRO_TORCH_GEMM_STRATEGY``) and the contraction fault sites (``pack``,
``kernel_compile``, ``kernel_run``, ``scale_grid``) run in the warm-up and
the capture pass only, as the reference's run at trace time. The numerics
guard reads nothing back while a capture is under way
(``core.health.numerics_guard_active``); the warm-up still checks.

**Launch counts.** The kernel wrappers count their launches by body in
Python (``.launches`` and ``.variants``), which a replay does not run. The
capture's per-wrapper, per-body delta over every registered wrapper
(``repro_torch.kernels.counted_wrappers()``) is recorded, taken back (the
capture pass launches nothing) and credited once per replay
(:class:`LaunchCredit`), so ``.variants`` keeps meaning launches by body
whatever issues them. The warm-up counts as an eager step.

On the CPU (``capture=False``) a call copies its inputs and runs the body
eagerly over the static tree: the function the card captures, which the
CPU tests hold to the reference.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels

# Families whose decode is not captured, each with its reason: ``(family,
# reason)``. They decode eagerly on the card. Every family captures today.
EAGER_FAMILIES: Tuple[Tuple[str, str], ...] = ()


# The side stream every graph warms up and captures on, one a device.
# torch keeps a cuBLAS workspace (32 MiB on an H100) for each stream a
# product has run on and never frees it: a stream a graph kept one such
# workspace for every prompt length a server had seen.
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_stream() -> "torch.cuda.Stream":
    """The current device's capture stream (made at its first use)."""
    device = torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def eager_reason(model_cfg) -> Optional[str]:
    """Why ``model_cfg``'s decode runs eagerly on the card (its family's
    entry in :data:`EAGER_FAMILIES`), or None when it is captured."""
    return dict(EAGER_FAMILIES).get(model_cfg.family)


# ---------------------------------------------------------------------------
# The static tree
# ---------------------------------------------------------------------------

def static_like(tree):
    """A tree of the same structure whose tensor leaves are new zeroed
    tensors of the leaves' shapes, dtypes and devices."""
    return _like(tree, torch.zeros_like)


def _like(tree, make):
    if isinstance(tree, dict):
        return {k: _like(v, make) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_like(v, make) for v in tree]
    return make(tree) if torch.is_tensor(tree) else tree


def signature(tree) -> tuple:
    """A hashable key of a tree's structure and its leaves' shapes and
    dtypes, a dict's keys in sorted order: two trees of one signature share
    a static tree."""
    if isinstance(tree, dict):
        return tuple((k, signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype, tree.device.type)
    return (tree,)


def copy_in(static, value) -> None:
    """Copy ``value`` into the static tree ``static`` leaf by leaf: a
    tensor or numpy array by copy, a Python number by ``fill_``. A dict
    ``value`` may hold only some of ``static``'s keys. The tensor leaves
    go in one multi-tensor copy where they share a device and a dtype: a
    batch-1 slot's caches are dozens of leaves, each a launch of its own
    otherwise."""
    pairs = []
    _pair_in(static, value, pairs)
    _copy(pairs)


def _pair_in(static, value, pairs) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _pair_in(static[k], v, pairs)
    elif isinstance(value, (list, tuple)):
        if len(value) != len(static):
            raise ValueError(f"{len(value)} leaves for a static list of "
                             f"{len(static)}")
        for s, v in zip(static, value):
            _pair_in(s, v, pairs)
    elif torch.is_tensor(value):
        if value.shape != static.shape:
            raise ValueError(f"input of shape {tuple(value.shape)} for a "
                             f"static leaf of {tuple(static.shape)}")
        if value is not static:
            pairs.append((static, value))
    elif isinstance(value, np.ndarray):
        _pair_in(static, torch.from_numpy(value), pairs)
    else:
        static.fill_(value)


def _copy(pairs) -> None:
    """``dst.copy_(src)`` for each pair: those of one device and dtype in
    one ``torch._foreach_copy_``, the others one by one. Under inference
    mode, as the served steps run: the engine's outputs (a request's
    caches) are inference tensors, written in place only there."""
    same = [(d, s) for d, s in pairs
            if d.device == s.device and d.dtype == s.dtype]
    with torch.inference_mode():
        if same:
            torch._foreach_copy_([d for d, _ in same], [s for _, s in same])
        for d, s in pairs:
            if d.device != s.device or d.dtype != s.dtype:
                d.copy_(s)


def clone(tree):
    """A copy of ``tree`` whose tensor leaves are new tensors: what a caller
    keeps of a graph's static outputs, which the next replay overwrites."""
    out = _like(tree, torch.empty_like)
    copy_in(out, tree)
    return out


def copy_back(static, new) -> None:
    """Copy each leaf of ``new`` that is not the static tree's own tensor
    into its static slot: the functional outputs of a decode (a new SSM
    state) land where the next step reads them. Leaves written in place
    (the KV caches) are the static tensors themselves and are skipped."""
    pairs = []
    _pair_back(static, new, pairs)
    _copy(pairs)


def _pair_back(static, new, pairs) -> None:
    if isinstance(static, dict):
        for k, v in static.items():
            _pair_back(v, new[k], pairs)
    elif isinstance(static, (list, tuple)):
        for s, v in zip(static, new):
            _pair_back(s, v, pairs)
    elif torch.is_tensor(static) and new is not static:
        pairs.append((static, new))


# ---------------------------------------------------------------------------
# Launch counts under replay
# ---------------------------------------------------------------------------

def launch_counts(wrappers: Iterable) -> Dict[Callable, Tuple[int, dict]]:
    """``{wrapper: (launches, launches by body)}`` as they stand."""
    return {fn: (fn.launches, dict(fn.variants)) for fn in wrappers}


class LaunchCredit:
    """What one capture pass counted, wrapper by wrapper and body by body,
    credited to the wrappers once per replay."""

    def __init__(self, before: dict, after: dict):
        self.delta = {}
        for fn, (n, bodies) in after.items():
            n0, bodies0 = before[fn]
            by_body = {b: c - bodies0.get(b, 0) for b, c in bodies.items()
                       if c != bodies0.get(b, 0)}
            if n != n0 or by_body:
                self.delta[fn] = (n - n0, by_body)

    def apply(self, times: int = 1) -> None:
        """Add the delta ``times`` times (-1 takes the capture's own
        counts back)."""
        for fn, (n, bodies) in self.delta.items():
            fn.launches += times * n
            for body, c in bodies.items():
                fn.variants[body] += times * c


# ---------------------------------------------------------------------------
# The captured step
# ---------------------------------------------------------------------------

class StepGraph:
    """``body(static) -> outputs`` over the static tree ``static``, captured
    into a CUDA graph on the card (``capture=True``) and run eagerly over
    the static tree on the CPU. Each call takes the inputs to copy into
    the static tree (:func:`copy_in`) and returns the outputs: the warm-up
    step's on the first call, the graph's static outputs after, which the
    next call overwrites. ``wrappers`` are the launch-counting kernel
    wrappers (``repro_torch.kernels.counted_wrappers()`` by default).
    ``pool`` (``torch.cuda.graph_pool_handle()``) is a memory pool shared
    with other graphs that replay one at a time on one stream; by default
    the graph has its own. The body should hold no reference to the
    graph's owner: a cycle through it would keep the owner, its weights
    and the graph alive until a garbage collection. The first call is the
    warm-up, the second captures and replays. ``warmup_ms`` (host clock,
    not synchronised: the time to issue the warm-up) and ``capture_ms``
    (host clock, synchronised) time the two passes;
    ``capture_reserved_bytes`` is the device memory the capture reserved
    (its pool's new segments) and :attr:`static_bytes` the static tree's;
    ``replays`` counts the replays. Calls run under
    ``torch.inference_mode``: a served step. With ``grad=True`` they run
    in the caller's grad mode instead, so that the body can differentiate
    (the train step, ``train.loop.make_train_step``): its static tree is
    made outside inference mode, and the capture starts from an emptied
    cache, since the warm-up's freed blocks belong to the capture stream
    and a train step's working set is most of the card's memory."""

    def __init__(self, body: Callable, static: dict, *, capture: bool,
                 wrappers: Optional[Iterable] = None, pool=None,
                 grad: bool = False):
        self.body = body
        self.static = static
        self.capture = capture
        self.pool = pool
        self.grad = grad
        self._wrappers = None if wrappers is None else tuple(wrappers)
        self.graph = None
        self.outputs = None
        self.credit: Optional[LaunchCredit] = None
        self.replays = 0
        self.warmup_ms = self.capture_ms = self.capture_reserved_bytes = None
        self._warmed = False

    @property
    def static_bytes(self) -> int:
        """Bytes of the static tree's tensors."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.static))

    def __call__(self, inputs: dict):
        mode = contextlib.nullcontext() if self.grad else torch.inference_mode()
        with mode:
            copy_in(self.static, inputs)
            if not self.capture:
                return self.body(self.static)
            if self.graph is None:
                if not self._warmed:
                    return self._timed_warm_up()
                self._timed_capture()
            self.graph.replay()
            self.credit.apply()
            self.replays += 1
            return self.outputs

    def _timed_warm_up(self):
        t0 = time.perf_counter()
        self._warmed = False
        out = self._warm_up()
        self._warmed = True
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        return out

    def _timed_capture(self) -> None:
        wrappers = self._wrappers or kernels.counted_wrappers()
        t0 = time.perf_counter()
        if self.grad:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = launch_counts(wrappers)
        try:
            graph, outputs = self._capture_graph()
        finally:
            # The capture pass launched nothing, whether or not it ended.
            credit = LaunchCredit(before, launch_counts(wrappers))
            credit.apply(-1)
        self.graph, self.outputs, self.credit = graph, outputs, credit
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.capture_reserved_bytes = torch.cuda.memory_reserved() - reserved

    def _warm_up(self):
        """The eager warm-up on the capture stream: this call's step. The
        card is not synchronised: a step seen once costs what an eager step
        costs."""
        stream = capture_stream()
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = self.body(self.static)
        current.wait_stream(stream)
        # The outputs were made on the capture stream and are read on this
        # one: keep their memory from reuse until this stream's reads end.
        for t in _leaves(out):
            t.record_stream(current)
        return out

    def _capture_graph(self):
        """Capture the body on the warm-up's stream: (graph, its static
        outputs). On an exception the capture is ended and the exception
        propagates."""
        # The capture starts from an idle card: this call's input copies
        # and the work before it done.
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        # No cyclic garbage collection during the capture: a graph it freed
        # (another step's, unreachable) would be destroyed mid-capture, a
        # call the capture forbids and is invalidated by.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(capture_stream()):
                graph.capture_begin(pool=self.pool)
                try:
                    outputs = self.body(self.static)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        # The capture was invalidated by what raised; the
                        # stream has left capture mode all the same, and
                        # the first exception is the one to report.
                        pass
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize()
        return graph, outputs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree
