"""Mamba2 SSD (state-space duality) mixer, chunked ("dual") form, in plain
torch as the reference's jnp version.

Within a chunk the selective-state-space recurrence is a few dense products;
only the small chunk-state recurrence runs in sequence (arXiv:2405.21060,
Listing 1). The block's two projections, ``in_proj`` and ``out_proj``, go
through ``core.gemm.linear`` like every dense weight (packed at load, they
run the fused-A kernel).

Layout: x [B, L, H, P] heads, B / C shared across heads (one group) [B, L,
N], A a scalar per head, dt per (token, head).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gemm
from repro_torch.core.contraction import as_compute_weight
from repro_torch.models.layers import init_const, init_normal, rms_norm_gated
from repro_torch.parallel.mesh import keep_shards, shard


def ssm_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """The reference's ``ssm_params`` tree: random ``in_proj`` [d, 2 di + 2 n
    + nh], ``conv_w`` [W, di + 2 n] and ``out_proj`` [di, d], N(0, 0.02),
    drawn from ``generator``; the deterministic ``conv_b`` (0), ``A_log``
    (log of 1 ... 16), ``dt_bias`` (softplus^-1(0.01)), ``D`` and ``norm``
    (1), all f32."""
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state_size, cfg.ssm_num_heads
    conv_ch = di + 2 * n

    return {
        # in_proj -> [z(di), x(di), B(n), C(n), dt(nh)]
        "in_proj": init_normal(generator, device, d, 2 * di + 2 * n + nh),
        "conv_w": init_normal(generator, device, cfg.ssm_conv_width, conv_ch),
        "conv_b": init_const(0.0, conv_ch, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "dt_bias": init_const(-4.6, nh, device),
        "D": init_const(1.0, nh, device),
        "norm": init_const(1.0, di, device),
        "out_proj": init_normal(generator, device, di, d),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """[..., T] -> [..., T, T] lower-triangular segment sums (log decay),
    -inf above the diagonal (so that exp gives 0 there)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual form. x [B, L, H, P], dt [B, L, H], a [H], b / c [B, L, N].

    Returns (y [B, L, H, P] in x's dtype, final state [B, H, P, N] f32). A
    length that is not a multiple of ``chunk`` is padded with zeros (dt 0:
    no decay and no input, so the final state is unchanged) and cut back."""
    bsz, length, nh, p = x.shape
    n = b.shape[-1]
    pad = (-length) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    f32 = torch.float32
    xb = x.reshape(bsz, nc, chunk, nh, p).to(f32)
    dtb = dt.reshape(bsz, nc, chunk, nh).to(f32)
    bb = b.reshape(bsz, nc, chunk, n).to(f32)
    cb = c.reshape(bsz, nc, chunk, n).to(f32)

    da = dtb * (-torch.exp(a.to(f32)))               # [B, nc, Q, H]
    da = da.permute(0, 3, 1, 2)                      # [B, H, nc, Q]
    da_cs = torch.cumsum(da, dim=-1)                 # within-chunk cumsum
    xdt = xb * dtb[..., None]                        # [B, nc, Q, H, P]

    # 1) within a chunk: C B^T, decayed, against x dt.
    decay = torch.exp(_segsum(da))                   # [B, H, nc, Q, Q]
    scores = torch.einsum("bcln,bcsn->bcls", cb, bb)[:, None] * decay
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xdt)

    # 2) each chunk's state at its end.
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)          # [B, H, nc, Q]
    states = torch.einsum("bcln,bclhp->bchpn", bb,
                          xdt * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3) the recurrence over chunk states (the one sequential part): each
    # chunk reads the state before it.
    state = (torch.zeros((bsz, nh, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    chunk_decay = torch.exp(da_cs[..., -1])                    # [B, H, nc]
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                     # [B, nc, H, P, N]

    # 4) what the earlier chunks' state adds within each chunk.
    state_decay_out = torch.exp(da_cs).permute(0, 2, 3, 1)     # [B, nc, Q, H]
    y_off = (torch.einsum("bcln,bchpn->bclhp", cb, prev_states)
             * state_decay_out[..., None])

    y = (y_diag + y_off).reshape(bsz, nc * chunk, nh, p)[:, :length]
    return y.to(x.dtype), state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x [B, L, C]; w [W, C]."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return out + bias[None, None, :]


def _conv_weight(p: dict, dtype) -> torch.Tensor:
    """``conv_w`` as the reference's layer cast leaves it (2-D, so rounded
    to the compute dtype), widened to f32 for the f32 convolution."""
    return p["conv_w"].to(dtype).to(torch.float32)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state_size
    return torch.split(proj, [di, di, n, n, cfg.ssm_num_heads], dim=-1)


def apply_ssm(cfg: ModelConfig, p: dict, x: torch.Tensor,
              return_state: bool = False):
    """Full-sequence Mamba2 block. x [B, S, d] -> [B, S, d], and with
    ``return_state`` the decode cache {"state", "conv"} too."""
    bsz, s, _ = x.shape
    di, n, nh, hp = (cfg.d_inner, cfg.ssm_state_size, cfg.ssm_num_heads,
                     cfg.ssm_head_dim)
    f32 = torch.float32
    proj = gemm.linear(x, as_compute_weight(p["in_proj"], x.dtype))
    z, xin, b, c, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in.to(f32), _conv_weight(p, x.dtype),
                                   p["conv_b"]))
    xin, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])
    xh = xin.reshape(bsz, s, nh, hp)
    y, final_state = ssd_chunked(xh, dt, p["A_log"], b, c, cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xh          # skip connection
    y = rms_norm_gated(y.reshape(bsz, s, di), z.to(f32), p["norm"])
    y = shard(y, "batch", None, "model")
    out = gemm.linear(y.to(x.dtype), as_compute_weight(p["out_proj"], x.dtype))
    if not return_state:
        return out
    w = cfg.ssm_conv_width - 1
    tail = conv_in.to(f32)[:, -w:]
    if s < w:  # a prompt shorter than the conv's receptive field
        tail = F.pad(tail, (0, 0, w - s, 0))
    return out, {"state": final_state, "conv": tail}


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """An empty decode cache, f32 (as the reference keeps it)."""
    di, n = cfg.d_inner, cfg.ssm_state_size
    return {
        "state": torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n),
                            dtype=torch.float32, device=device),
    }


def decode_ssm(cfg: ModelConfig, p: dict, x: torch.Tensor,
               cache: dict) -> Tuple[torch.Tensor, dict]:
    """One-token SSD recurrence. x [B, 1, d] -> ([B, 1, d], new cache)."""
    bsz = x.shape[0]
    di, n, nh, hp = (cfg.d_inner, cfg.ssm_state_size, cfg.ssm_num_heads,
                     cfg.ssm_head_dim)
    f32 = torch.float32
    proj = gemm.linear(x[:, 0], as_compute_weight(p["in_proj"], x.dtype))
    # Under a mesh the step's per-head tensors keep only their batch shard
    # (an uneven head shard cannot be folded by the einsums below).
    z, xin, b, c, dt = _split_proj(cfg, keep_shards(proj, (0,)))
    conv_in = torch.cat([xin, b, c], dim=-1).to(f32)
    window = torch.cat([cache["conv"], conv_in[:, None]], dim=1)
    conv_out = F.silu((window * _conv_weight(p, x.dtype)[None]).sum(1)
                      + p["conv_b"])
    xin, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                 # [B, nh]
    da = torch.exp(dt * (-torch.exp(p["A_log"])))              # [B, nh]
    xh = xin.reshape(bsz, nh, hp)
    # state <- decay * state + dt * x (outer) B
    new_state = keep_shards(cache["state"] * da[..., None, None]
                            + torch.einsum("bhp,bn,bh->bhpn", xh, b, dt),
                            (0,))
    y = (torch.einsum("bhpn,bn->bhp", new_state, c)
         + p["D"][None, :, None] * xh)
    y = rms_norm_gated(y.reshape(bsz, di), z.to(f32), p["norm"])
    out = gemm.linear(y.to(x.dtype), as_compute_weight(p["out_proj"], x.dtype))
    return out[:, None], {"state": new_state, "conv": window[:, 1:]}
