"""The train step: forward + backward + AdamW, with microbatch gradient
accumulation, optional bf16 gradient compression and a straggler monitor,
as the reference's ``repro/train/loop.py`` builds it.

Parameters stay f32 masters; every contraction casts its weight to the
compute dtype per call (``contraction.as_compute_weight``), and on the card
the raw weights are packed per call (K5, then K1) by the dispatch: no
packed copy of a weight is kept across calls, so none can outlive an
optimizer step. Gradients through the kernel contractions come from
``core.autograd.KernelContraction``.

On the card the step is captured into a CUDA graph and replayed
(:class:`TrainStep`), updating the params and the optimizer state in place,
as the reference jits its step with the two donated.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.models import Model
from repro_torch.parallel.mesh import is_dtensor, local_rows, settle
from repro_torch.serve import graphs
from repro_torch.train import losses
from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import AdamWConfig, tree_leaves, tree_map

METRIC_KEYS = ("loss", "xent", "accuracy", "moe_aux")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = AdamWConfig()
    microbatches: int = 1            # gradient accumulation steps
    remat: bool = True
    grad_compression: Optional[str] = None  # None | "bf16"


def tree_unflatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """``tree``'s structure with its leaves (in :func:`tree_leaves`'
    order) replaced by ``leaves``."""
    it: Iterator = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return next(it)
    return walk(tree)


def _grads_fn(model: Model, train_cfg: TrainConfig):
    """(params, batch) -> (grads, metrics): the gradient of the train loss
    by autograd, f32 like the masters; metrics detached."""
    def grads_fn(params, batch):
        req = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            logits, aux = model.forward(req, batch, remat=train_cfg.remat)
            loss, metrics = losses.train_loss(logits, batch["labels"], aux)
            grads = torch.autograd.grad(loss, tree_leaves(req),
                                        allow_unused=True,
                                        materialize_grads=True)
        return (tree_unflatten(params, list(grads)),
                {k: settle(metrics[k].detach()) for k in METRIC_KEYS})
    return grads_fn


def _split_microbatches(batch: dict, n: int) -> List[dict]:
    """``n`` microbatches of contiguous rows. A batch sharded over a mesh
    (DTensor leaves) splits each rank's rows the same way, so the rows stay
    where they are: microbatch i is every rank's i-th slice (the gradient,
    a mean over all rows, is the same sum in another order)."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: local_rows(v, i, n) if is_dtensor(v)
             else v[i * (b // n):(i + 1) * (b // n)]
             for k, v in batch.items()} for i in range(n)]


def _compress(grads: Any, mode: Optional[str]) -> Any:
    """Gradient compression: the gradients rounded to bf16 before they feed
    the optimizer (the reference narrows its cross-pod all-reduce so)."""
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).to(torch.float32),
                        grads)
    if mode is not None:
        raise ValueError(f"grad_compression must be None or 'bf16'; got "
                         f"{mode!r}")
    return grads


def _eager_step(model: Model, train_cfg: TrainConfig
                ) -> Callable[[Any, dict, dict], Tuple[Any, dict, dict]]:
    """The functional train step, run eagerly: ``(params, opt_state, batch)
    -> (new params, new opt_state, metrics)``, new trees every call. With
    microbatches the gradient and metrics are the means over them."""
    grads_fn = _grads_fn(model, train_cfg)
    n_micro = train_cfg.microbatches

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            grads, metrics = grads_fn(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            ms = []
            for mb in _split_microbatches(batch, n_micro):
                g, m = grads_fn(params, mb)
                grads = tree_map(torch.add, grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / n_micro, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean(0)
                       for k in METRIC_KEYS}
        grads = _compress(grads, train_cfg.grad_compression)
        new_params, new_state, opt_metrics = opt.apply_updates(
            train_cfg.optim, params, grads, opt_state)
        return new_params, new_state, dict(metrics, **opt_metrics)

    return train_step


def _train_body(step: Callable, static: dict) -> dict:
    """The captured train step: the functional step over the static tree,
    its new params and optimizer state written into the static leaves (one
    multi-tensor copy a tree), its metrics returned. A function of the
    eager step, not of its owner, so that the graph holds no reference
    back to it."""
    new_params, new_state, metrics = step(static["params"], static["opt"],
                                          static["batch"])
    with torch.no_grad():
        for old, new in ((static["params"], new_params),
                         (static["opt"], new_state)):
            torch._foreach_copy_(tree_leaves(old), tree_leaves(new))
    return metrics


class TrainStep:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the port's counterpart of the reference's
    ``jax.jit(step_fn, donate_argnums=(0, 1))``, with metrics ``loss``,
    ``xent``, ``accuracy``, ``moe_aux``, ``grad_norm`` and ``lr`` (0-d
    tensors).

    **Donation.** The first call adopts the caller's ``params`` and
    ``opt_state`` tensors as the step's static tree, with no copy, and
    every call returns those same tensors, written in place: the caller's
    trees before the call are the step's from then on. A later call that
    passes other tensors (a restored checkpoint) has them copied in
    (``graphs.copy_in``), never rebound: the kernels' tensor maps hold the
    static addresses. The batch is copied into a static batch each call.

    **Where it runs.** On the card the step is a ``serve.graphs.StepGraph``
    in grad mode: the first call runs the functional step eagerly on the
    capture stream (its warm-up), the second captures it, and later calls
    replay it, with the launch counts credited per replay. The metrics
    are then the graph's static outputs, which the next call overwrites.
    On the CPU the same body runs eagerly over the static tree: the
    function the card captures. The values are bitwise those of the
    functional step (``_eager``, the step a graph is compared with), which
    returns new trees instead.

    **The guard.** The contractions are guarded, and the fault sites and
    the numerics guard fire, at the warm-up and the capture only, as the
    reference checks its jit'd step at trace time; a replay runs no guard
    (``serve.Engine.health_report``). A failed warm-up or capture raises
    (naming the failing contraction's spec) and leaves the static tree as
    it was; the next call warms up, or captures, again."""

    def __init__(self, model: Model, train_cfg: TrainConfig):
        self._eager = _eager_step(model, train_cfg)
        self._capture = model.device.type == "cuda"
        self.graph: Optional[graphs.StepGraph] = None

    def __call__(self, params, opt_state, batch):
        if self.graph is None:
            static = {"params": params, "opt": opt_state,
                      "batch": graphs.static_like(batch)}
            self.graph = graphs.StepGraph(
                functools.partial(_train_body, self._eager), static,
                capture=self._capture, grad=True)
        metrics = self.graph({"params": params, "opt": opt_state,
                              "batch": batch})
        return self.graph.static["params"], self.graph.static["opt"], metrics


def make_train_step(model: Model, train_cfg: TrainConfig) -> TrainStep:
    """The train step of ``model`` (:class:`TrainStep`): captured into a
    CUDA graph on the card, updating the params and optimizer state in
    place."""
    return TrainStep(model, train_cfg)


class StragglerMonitor:
    """Step-time EWMA monitor — flags steps that exceed the running norm
    (flag > mean + k * std), so a launcher can checkpoint and reschedule a
    chronic straggler. Driven by the local loop."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self.ewvar: float = 0.0
        self.flagged: list = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        if self.ewma is None:
            self.ewma = dt
            return False
        dev = dt - self.ewma
        self.ewma += self.alpha * dev
        self.ewvar = (1 - self.alpha) * (self.ewvar + self.alpha * dev * dev)
        slow = dt > self.ewma + self.threshold * (self.ewvar ** 0.5 + 1e-9)
        if slow:
            self.flagged.append((step, dt))
        return slow
