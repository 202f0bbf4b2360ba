"""The sampled draw as plain torch on the device: the port's counterpart of
the reference's jit'd Gumbel-argmax (``jax.random.categorical`` inside
``src/repro/serve/engine.py`` ``_sampled``).

**Keys.** Row r's key is splitmix64 over (seed, request_id, step)
(:func:`row_keys`, on the host, one vectorised numpy pass over the rows),
so a request's stream depends on those three only, never on its batch
neighbours, its row or the batch width.

**Uniforms.** Element v of row r takes the splitmix64 output of the
counter ``key[r] + (v + 1) * golden`` (mod 2^64): its top 23 bits m give
``u = (2m + 1) / 2^24``, strictly inside (0, 1) and exact in f32. The hash
runs in int64 torch ops, whose products and sums wrap mod 2^64; torch's
``>>`` on int64 is arithmetic, so every shift is masked to a logical one.

**Draw.** The token is ``argmax(logits * (1 / T) + g)`` in f32, with the
Gumbel noise ``g = -log(-log(u))`` computed in f64 and rounded to f32, and
``1 / T`` rounded to f32 once. Both choices make the draw a function of
IEEE arithmetic alone: an f32 ``log`` differs in its last bit between
libraries, and torch divides by a scalar on the card as a multiply by its
reciprocal. So the CPU, the card and a numpy reference agree to the bit
(a rare one-ulp difference in an f64 ``log`` can still move a rounding).
``torch.argmax`` takes the first maximal index, as numpy's does.

**Non-finite rows.** A row whose softmax is not finite (a NaN, a +Inf, or
every logit -Inf; only the opt-in numerics guard evicts such a row)
takes ``argmax(logits)``, selected by ``torch.where``: nothing is read
back. The reference's draw lands on its first NaN likewise.

The streams differ from the reference's threefry streams (as any stream
of another generator would); greedy decoding does not sample.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB


def _signed(x: int) -> int:
    """``x`` mod 2^64 as a signed 64-bit value (what an int64 tensor holds)."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor by ``s`` bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def row_keys(seed: int, request_ids, steps) -> np.ndarray:
    """Each row's key, splitmix64 over (seed, request_id, step), in
    [0, 2^63): int64 [B]. ``steps`` broadcasts against ``request_ids``."""
    rids = np.asarray(request_ids, np.int64).reshape(-1)
    steps = np.broadcast_to(np.asarray(steps, np.int64), rids.shape)
    x = np.full(rids.shape, GOLDEN, np.uint64)
    for v in (np.full(rids.shape, seed & _MASK64, np.uint64),
              rids.astype(np.uint64), steps.astype(np.uint64)):
        x = (x ^ v) * np.uint64(MIX1)
        x = (x ^ (x >> np.uint64(31))) * np.uint64(MIX2)
        x ^= x >> np.uint64(29)
    return (x & np.uint64((1 << 63) - 1)).astype(np.int64)


def uniforms(keys: torch.Tensor, width: int) -> torch.Tensor:
    """u [B, width] (f32 values, held in f64) in (0, 1) for int64 ``keys``
    [B]: the splitmix64 output of ``key + (v + 1) * golden``."""
    ctr = torch.arange(1, width + 1, dtype=torch.int64, device=keys.device)
    x = keys[:, None] + ctr * _signed(GOLDEN)
    x = (x ^ _shr(x, 30)) * _signed(MIX1)
    x = (x ^ _shr(x, 27)) * _signed(MIX2)
    x = x ^ _shr(x, 31)
    return (_shr(x, 41) * 2 + 1).to(torch.float64) * 2.0 ** -24


def gumbel(keys: torch.Tensor, width: int) -> torch.Tensor:
    """The Gumbel noise ``-log(-log(u))`` [B, width], f64 rounded to f32."""
    return (-torch.log(-torch.log(uniforms(keys, width)))).to(torch.float32)


def draw(logits: torch.Tensor, keys: torch.Tensor,
         temperature: float) -> torch.Tensor:
    """One token per row of ``logits`` [B, V] (int32 [B]): the Gumbel-argmax
    draw from ``softmax(logits / temperature)`` with row r's noise from
    ``keys[r]``; a row whose softmax is not finite takes its argmax."""
    x = logits.to(torch.float32)
    inv_t = float(np.float32(1.0 / temperature))
    sampled = torch.argmax(x * inv_t + gumbel(keys, x.shape[-1]), dim=-1)
    finite = torch.isfinite(x.amax(dim=-1))
    return torch.where(finite, sampled,
                       torch.argmax(logits, dim=-1)).to(torch.int32)
