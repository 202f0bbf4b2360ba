"""Every model family served packed on the card against the same model on
the plain path, without JAX (the machine with the card has none; the
parity with the JAX package is ``tests/test_torch_families.py``).

A narrow config of each of the eight configs beyond olmo-1b and mixtral
(2 layers, d_model 256, heads of 64, d_ff 512, vocab 512; mamba2's and
hymba's ``in_proj`` N = 1064 is not a multiple of K1's bn of 64) with
packed weights, so that on the card every projection and the LM head run
on K1 and llama4-scout's experts on K2:

  * ``cuda``: bf16, prefill and one decode step's logits of the kernels
    against the same engine with the plain versions swapped in, within
    5e-2 relative (Frobenius), as chip_smoke gates the served models;
    llama4's plain run replays the kernel run's routing, so that a bf16
    near-tie in its top-1 router cannot move a token to another expert.
  * ``cpu``: f32, the packed engine against the raw-weight engine, within
    1e-4 of the logit scale.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import layered
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import gemm_packed as gp
from repro_torch.models import build
from repro_torch.models import moe
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

ARCHS = ["command-r-plus-104b", "phi3-mini-3.8b", "qwen3-4b",
         "llama4-scout-17b-a16e", "whisper-base", "paligemma-3b",
         "hymba-1.5b", "mamba2-130m"]
DEVICES = [pytest.param("cpu"), pytest.param("cuda", marks=pytest.mark.cuda)]
PROMPT = (2, 8)


def _cfg(arch, dtype):
    cfg = reduced_config(arch)
    changes = dict(d_model=256, d_ff=512 if cfg.d_ff else 0, vocab_size=512,
                   compute_dtype=dtype)
    if cfg.num_heads:
        changes.update(head_dim=64)
    if cfg.has_ssm:
        changes.update(ssm_head_dim=64)
    return dataclasses.replace(cfg, **changes)


def _batch(cfg, device):
    gen = torch.Generator(device="cpu").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, PROMPT, generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((PROMPT[0], cfg.num_patches, cfg.d_model),
                                       generator=gen)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((PROMPT[0], cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _engine(cfg, device, params, pack):
    dtype = cfg.compute_dtype
    return Engine(build(cfg, device=device), params,
                  ServeConfig(max_len=48, pack_weights=pack, cache_dtype=dtype),
                  device=device)


class _plain:
    """Within the block the packed lowerings call K1's and K2's plain
    versions; with ``replay`` each ``moe.route`` call returns the recorded
    routing of the same call in the kernel run."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        self.saved = (layered.gemm_packed_fused_a,
                      layered.gemm_grouped_packed_ragged, moe.route)
        layered.gemm_packed_fused_a = gp.gemm_packed_fused_a_plain
        layered.gemm_grouped_packed_ragged = gg.gemm_grouped_packed_ragged_plain
        if self.replay is not None:
            calls = iter(self.replay)
            moe.route = lambda *a: next(calls)

    def __exit__(self, *exc):
        (layered.gemm_packed_fused_a, layered.gemm_grouped_packed_ragged,
         moe.route) = self.saved


class _recording:
    def __enter__(self):
        self.routes, self.real = [], moe.route

        def fn(*a):
            out = self.real(*a)
            self.routes.append(out)
            return out
        moe.route = fn
        return self

    def __exit__(self, *exc):
        moe.route = self.real


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def _forward(engine, batch):
    """Prefill, then one decode step of the prefill's greedy tokens."""
    logits, caches = engine._prefill(batch)
    tok = torch.argmax(logits, -1)[:, None]
    prefix = engine.model.cfg.num_patches if engine.model.cfg.family == "vlm" else 0
    pos = torch.full((PROMPT[0],), prefix + PROMPT[1], dtype=torch.long,
                     device=logits.device)
    step, _ = engine._decode(caches, tok, pos)
    return logits, tok, step[:, 0]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_family_matches_the_plain_path(arch, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg = _cfg(arch, "bfloat16" if device == "cuda" else "float32")
    model = build(cfg, device=device)
    params = model.init(0)
    batch = _batch(cfg, device)
    if device == "cpu":
        want_pre, tok, want_dec = _forward(_engine(cfg, device, params, False),
                                           batch)
        got_pre, got_tok, got_dec = _forward(_engine(cfg, device, params, True),
                                             batch)
        assert torch.equal(got_tok, tok)
        for got, want in ((got_pre, want_pre), (got_dec, want_dec)):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-4 * scale
        return
    engine = _engine(cfg, device, _cast(params, torch.bfloat16), True)
    del params
    gp.gemm_packed_fused_a.launches = 0
    gg.gemm_grouped_packed_ragged.launches = 0
    with _recording() as rec:
        got_pre, tok, got_dec = _forward(engine, batch)
    per_forward = gp.gemm_packed_fused_a.launches
    assert per_forward > 0
    assert (gg.gemm_grouped_packed_ragged.launches > 0) == cfg.is_moe
    with _plain(rec.routes if cfg.is_moe else None):
        logits, caches = engine._prefill(batch)
        prefix = cfg.num_patches if cfg.family == "vlm" else 0
        pos = torch.full((PROMPT[0],), prefix + PROMPT[1], dtype=torch.long,
                         device=device)
        step, _ = engine._decode(caches, tok, pos)
    assert gp.gemm_packed_fused_a.launches == per_forward
    assert bool(torch.isfinite(got_pre).all()) and bool(torch.isfinite(got_dec).all())
    assert _rel(got_pre, logits) <= 5e-2
    assert _rel(got_dec, step[:, 0]) <= 5e-2
