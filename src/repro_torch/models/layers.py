"""Shared model building blocks: norms, RoPE, the MLP, embeddings, the LM
head and chunked exact attention.

Every dense contraction goes through ``repro_torch.core.gemm.linear``.
Weights are raw [K, N] tensors or :class:`PackedWeight`s packed once at
load by :func:`pack_model_params`; the packed form runs the fused-A kernel
with bias and activation in its store epilogue. MoE expert stacks pack as
:class:`GroupedPackedWeight`s (see ``models/moe.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gemm
from repro_torch.core.contraction import as_compute_weight
from repro_torch.core.dtypes import torch_dtype
from repro_torch.core.epilogue import EPILOGUE_SPECS, EpilogueSpec
from repro_torch.core.layered import GroupedPackedWeight, PackedWeight
from repro_torch.parallel.mesh import is_dtensor, shard, sharded_attention

# Every random matrix of an initial tree is N(0, INIT_STD), as the
# reference's.
INIT_STD = 0.02


def init_normal(generator: torch.Generator, device, *shape) -> torch.Tensor:
    """A random f32 leaf [*shape], N(0, INIT_STD), drawn from ``generator``."""
    return torch.randn(shape, generator=generator, device=device).mul_(INIT_STD)


def init_const(fill: float, n: int, device) -> torch.Tensor:
    """A deterministic f32 leaf [n] filled with ``fill``."""
    return torch.full((n,), fill, dtype=torch.float32, device=device)


# Dense [K, N] weight names packed at load time, across every family
# (attention, MLP, the SSM's projections).
DENSE_WEIGHT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "wg", "wu", "wi", "in_proj", "out_proj"})

# Stacked [E, K, N] expert-weight names inside a "moe" subtree, packed
# grouped at load time. The gate/up pair plans for the silu-gate kernel's
# second B stream (n_b_streams=2), so both stacks share one plan. The
# router stays a raw [d, E] tensor.
GROUPED_WEIGHT_KEYS = frozenset({"wg", "wu", "wo"})
_GATE_PAIR_KEYS = frozenset({"wg", "wu"})


def pack_model_params(cfg: ModelConfig, params: dict, *, dtype=None,
                      quantize=None) -> dict:
    """Load-time packing pass: every dense weight becomes a PackedWeight in
    the compute dtype, every expert stack of a "moe" subtree a
    GroupedPackedWeight, and ``head_packed`` holds the packed LM head
    ([d_model, vocab], from the tied embedding or the head table).
    ``quantize`` ("int8" | "int4", optional ":col") quantizes all of them,
    the expert stacks included. Leaves that are packed already (for
    example carried across from the reference by ``interop``) stay as
    they are, ``head_packed`` included."""
    compute = torch_dtype(dtype or cfg.compute_dtype)

    def walk(tree, in_moe=False):
        if isinstance(tree, list):
            return [walk(v, in_moe) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for key, val in tree.items():
            is_float = torch.is_tensor(val) and val.is_floating_point()
            if in_moe and key in GROUPED_WEIGHT_KEYS and is_float \
                    and val.dim() == 3:
                out[key] = GroupedPackedWeight.pack(
                    val.to(compute), quantize=quantize,
                    n_b_streams=2 if key in _GATE_PAIR_KEYS else 1)
            elif not in_moe and key in DENSE_WEIGHT_KEYS and is_float \
                    and val.dim() == 2:
                out[key] = PackedWeight.pack(val.to(compute),
                                             quantize=quantize)
            else:
                out[key] = walk(val, in_moe or key == "moe")
        return out

    out = walk(params)
    if "head_packed" not in out:
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"]["table"])
        out["head_packed"] = PackedWeight.pack(table.t().to(compute),
                                               quantize=quantize)
    if not cfg.tie_embeddings:
        out.pop("head", None)  # the packed head replaces the raw table
    return out


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, LayerNorm, or olmo's non-parametric LayerNorm (no scale, no
    bias), computed in f32."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf * p["scale"]
    else:  # layernorm / nonparametric_ln
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        if "scale" in p:
            out = out * p["scale"]
        if "bias" in p:
            out = out + p["bias"]
    return out.to(x.dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's gated RMSNorm: norm(x * silu(z)) * scale."""
    xf = (x * torch.nn.functional.silu(z)).to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (absolute)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs      # [B,S,D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """[seq_len, d_model] f32: sin on the even columns, cos on the odd."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None]
    # Scalars stay on the host: a host tensor copied to the card per call
    # would synchronise, which a captured decode step (whisper's) forbids.
    angle = pos / torch.pow(10000.0, dim / d_model)
    emb = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(angle)
    emb[:, 1::2] = torch.cos(angle)
    return emb


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU / GeGLU (activation fused into the gate projection's
    epilogue), or a plain gelu MLP."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = EpilogueSpec(activation="silu" if cfg.mlp_type == "swiglu"
                           else "gelu")
        gate = gemm.linear(x, as_compute_weight(p["wg"], x.dtype),
                           p.get("bi"), epilogue=act)
        up = gemm.linear(x, as_compute_weight(p["wu"], x.dtype))
        h = gate * up
    else:
        h = gemm.linear(x, as_compute_weight(p["wi"], x.dtype), p.get("bi"),
                        epilogue=EPILOGUE_SPECS["gelu"])
    h = shard(h, "batch", None, "model")
    out = gemm.linear(h, as_compute_weight(p["wo"], x.dtype), p.get("bo"))
    # Megatron-SP epilogue: the TP-partial down-projection reduce-scatters
    # into the seq-sharded residual stream.
    return shard(out, "batch", "seq")


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` under ``torch.utils.checkpoint`` (not
    reentrant): its activations are dropped after the forward and
    recomputed in the backward, with the same values. The models draw no
    random numbers, so no generator state is saved for the recompute:
    reading the CUDA generator's state is refused while a stream captures
    (the train step's graph).

    An exception of the forward is raised after the checkpoint has
    returned: torch before 2.13 leaves the checkpoint's saved-tensor hooks
    installed when its function raises, and every later forward of the
    thread then saves into the failed call's frame (a train step after a
    failed warm-up fails its backward). The recompute runs ``fn`` as it
    is, so that the checkpoint's own early stop passes through."""
    if not remat:
        return fn(*args)
    state = {"forward": True, "error": None}

    def run(*a):
        if not state["forward"]:
            return fn(*a)
        try:
            return fn(*a)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            state["error"] = exc
            return None
    out = torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                            preserve_rng_state=False)
    state["forward"] = False
    if state["error"] is not None:
        raise state["error"]
    return out


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    # Gather, then cast: the same values as casting the table first, without
    # a per-step copy of the whole table. Under a mesh the table is first
    # laid out vocab-sharded with d replicated, as the reference's is.
    table = shard(params["embed"]["table"], "model", None)
    x = table[tokens].to(compute_dtype)
    if cfg.family == "vlm":  # gemma-style scaled embeddings
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
    return shard(x, "batch")


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32. The packed head stores in x's dtype (bf16 in serving)
    and is then widened, as the reference rounds them."""
    head = params.get("head_packed")
    if head is None:
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"]["table"])
        # Megatron vocab-parallel head layout under a mesh: [d, V], d
        # replicated, vocab over "model".
        head = shard(table.t().to(x.dtype), None, "model")
    logits = gemm.linear(x, head, accum="f32").to(torch.float32)
    return shard(logits, "batch", None, "model")


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int] = None,
                      prefix_len: int = 0, q_offset: int = 0,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_valid: Optional[torch.Tensor] = None,
                      k_positions: Optional[torch.Tensor] = None,
                      chunk: int = 512) -> torch.Tensor:
    """Exact attention over query chunks (bounded peak memory), in plain
    torch as the reference's jnp ``chunked_attention``.

    q: [B,Sq,H,D]; k/v: [B,Skv,Hkv,D]; GQA by ``head // group``. Masked
    logits are ``-1e30``, so a fully masked row gets uniform weights.
    DTensor operands (a mesh's layout) run on each rank's local batch rows
    and heads (:func:`sharded_attention`)."""
    if is_dtensor(q):
        return sharded_attention(
            chunked_attention, q, k, v, causal=causal, window=window,
            prefix_len=prefix_len, q_offset=q_offset, q_positions=q_positions,
            kv_valid=kv_valid, k_positions=k_positions, chunk=chunk)
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    if k_positions is None:
        k_positions = torch.arange(skv, device=dev)[None].expand(b, skv)
    if q_positions is None:
        q_positions = q_offset + torch.arange(sq, device=dev)[None]
    qpos_all = q_positions.expand(b, sq)
    # K and V widened once a call, outside the chunk loop. The reference
    # keeps them in their storage dtype and asks its einsums for f32
    # results; torch's bf16 / f16 matmul returns its operands' dtype, so an
    # f32 product of exact bf16 values needs f32 operands: the copies stay.
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    outs = []
    for c0 in range(0, sq, chunk):
        qs = q[:, c0:c0 + chunk]
        cs = qs.shape[1]
        qpos = qpos_all[:, c0:c0 + chunk]
        qg = qs.reshape(b, cs, hkv, group, d).to(torch.float32)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        qpb = qpos[:, :, None]
        kpb = k_positions[:, None, :]
        mask = torch.ones((b, cs, skv), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpb >= kpb
        if window is not None:
            mask &= (qpb - kpb) < window
        if prefix_len:
            mask |= (qpb < prefix_len) & (kpb < prefix_len)
        if kv_valid is not None:
            mask &= kv_valid[:, None, :]
        logits = torch.where(mask[:, None, None], logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        # The weights are rounded to V's dtype before the value product.
        out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(torch.float32),
                           vf)
        outs.append(out.reshape(b, cs, h, d).to(q.dtype))
    return torch.cat(outs, dim=1)
