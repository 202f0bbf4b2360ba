"""Losses: next-token cross entropy with a z-loss, and the MoE aux term, as
the reference computes them (``repro/train/losses.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def next_token_xent(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, dict]:
    """logits [B, S, V] f32; labels [B, S] (already shifted by the
    pipeline). Cross entropy by logsumexp plus ``Z_LOSS_WEIGHT * lse^2``,
    averaged over the mask; also the masked xent and argmax accuracy."""
    lse = torch.logsumexp(logits, dim=-1)                          # [B, S]
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    xent = lse - gold
    per_tok = xent + Z_LOSS_WEIGHT * torch.square(lse)
    mask = (torch.ones_like(xent) if mask is None
            else mask.to(torch.float32))
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (per_tok * mask).sum() / denom
    acc = ((torch.argmax(logits, -1) == labels) * mask).sum() / denom
    return loss, {"xent": (xent * mask).sum() / denom, "accuracy": acc}


def train_loss(logits: torch.Tensor, labels: torch.Tensor,
               moe_aux: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    loss, metrics = next_token_xent(logits, labels)
    total = loss + MOE_AUX_WEIGHT * moe_aux
    return total, dict(metrics, loss=total, moe_aux=moe_aux)
