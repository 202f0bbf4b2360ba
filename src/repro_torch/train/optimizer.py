"""AdamW with global-norm clipping and a warmup + cosine schedule, as plain
functions on trees of tensors (dicts and per-layer lists), in the
reference's order of operations (``repro/train/optimizer.py``): weight
decay joins the Adam direction in ``delta``, then ``p - lr * delta`` is
cast to ``p``'s dtype. ``torch.optim.AdamW`` decays the weights before the
step instead, so it is not used.

The state is ``{"mu": tree, "nu": tree, "step": int32 scalar}``, congruent
with the params.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (f32): linear warmup, then cosine down
    to ``min_lr_ratio * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cosine = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cosine)


def init_state(params: Any) -> dict:
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params), "step": step}


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: dict) -> Tuple[Any, dict, dict]:
    """One AdamW step: (params, state, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    # From the Python floats: a tensor made of them would be a host-to-device
    # copy, which a stream under capture refuses.
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32)
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) \
            + cfg.weight_decay * p
        return (p - lr * delta).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return (_pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2),
                            "step": step},
            {"grad_norm": gnorm, "lr": lr})


def _pick(tree: Any, i: int) -> Any:
    """Element ``i`` of every (p, mu, nu) triple at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
