"""The train step: forward + backward + AdamW, with microbatch gradient
accumulation, optional bf16 gradient compression and a straggler monitor,
as the reference's ``repro/train/loop.py`` builds it.

Parameters stay f32 masters; every contraction casts its weight to the
compute dtype per call (``contraction.as_compute_weight``), and on the card
the raw weights are packed per call (K5, then K1) by the dispatch: no
packed copy of a weight is kept across calls, so none can outlive an
optimizer step. Gradients through the kernel contractions come from
``core.autograd.KernelContraction``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.models import Model
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
                {k: metrics[k].detach() for k in METRIC_KEYS})
    return grads_fn


def _split_microbatches(batch: dict, n: int) -> List[dict]:
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


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


def make_train_step(model: Model, train_cfg: TrainConfig
                    ) -> Callable[[Any, dict, dict], Tuple[Any, dict, dict]]:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``xent``, ``accuracy``, ``moe_aux``,
    ``grad_norm`` and ``lr`` (0-d tensors). With microbatches the gradient
    and metrics are the means over them."""
    grads_fn = _grads_fn(model, train_cfg)
    n_micro = train_cfg.microbatches

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            grads, metrics = grads_fn(params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
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
