"""The continuous-batching scheduler's bitwise clauses without JAX, on the
card through K1 (the machine with the card has no JAX, so these live here;
``tests/test_torch_serve_continuous.py`` holds the same clauses and the
parity with the JAX package on the CPU):

  (a) a row of the shared batched step is bit for bit the same row run at
      the same width with every other row dead;
  (b) preempt / resume under a small pool gives the roomy run's tokens bit
      for bit;
  (c) bisection evicts exactly one row, and the survivors are bitwise the
      undisturbed run.

A small olmo-1b-shaped decoder (2 layers, d_model 256, 4 heads of 64,
d_ff 512, vocab 512) with packed weights, so that on the card every
projection and the LM head run on K1 (``gemm_packed_fused_a``). Each test
runs on the CPU too (f32, the kernels' plain versions); the ``cuda`` cases
skip without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import health
from repro_torch.kernels import gemm_packed as gp
from repro_torch.models import build
from repro_torch.serve import (ContinuousConfig, ContinuousScheduler, Engine,
                               Request, ServeConfig, VirtualClock)
from repro_torch.testing import faults

torch.set_num_threads(1)

DEVICES = [pytest.param("cpu"), pytest.param("cuda", marks=pytest.mark.cuda)]
_ENGINES = {}


def _engine(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if device not in _ENGINES:
        dtype = "bfloat16" if device == "cuda" else "float32"
        cfg = dataclasses.replace(
            reduced_config("olmo-1b"), d_model=256, num_heads=4,
            num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=512,
            compute_dtype=dtype)
        model = build(cfg, device=device)
        params = model.init(0)
        if device == "cuda":
            params = _cast(params, torch.bfloat16)
        _ENGINES[device] = Engine(
            model, params,
            ServeConfig(max_len=64, temperature=0.7, seed=3, cache_dtype=dtype,
                        pack_weights=True), device=device)
    return _ENGINES[device]


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    monkeypatch.delenv(health.ENV_NUMERICS_GUARD, raising=False)
    faults.reset()
    health.clear_serve()
    yield
    faults.reset()
    health.clear_serve()


def _requests(n=8, seed=1):
    r = np.random.default_rng(seed)
    return [Request(request_id=i,
                    tokens=r.integers(0, 512, int(r.choice((8, 16, 24))))
                    .astype(np.int32),
                    max_new_tokens=int(r.choice((6, 10, 16))))
            for i in range(n)]


def _serve(engine, **kw):
    clock = VirtualClock()
    cs = ContinuousScheduler(
        engine, ContinuousConfig(**{"queue_capacity": 32, "max_live": 4,
                                    "block_size": 8, **kw}),
        clock=clock, sleep=clock.sleep)
    for r in _requests():
        cs.submit(r)
    cs.drain(max_ticks=20_000)
    s = cs.stats()
    assert s["offered"] == s["admitted"] == 8
    assert cs.kv.alloc.free_count == cs.kv.alloc.capacity
    assert cs.kv.accounting_consistent()
    health.clear_serve()
    return cs, s, {rid: r.tokens.copy() for rid, r in cs.results.items()}


@pytest.mark.parametrize("device", DEVICES)
def test_batched_row_is_bitwise_the_row_alone(device):
    engine = _engine(device)
    clock = VirtualClock()
    cs = ContinuousScheduler(engine, ContinuousConfig(max_live=4, block_size=8),
                             clock=clock, sleep=clock.sleep)
    for r in _requests(4):
        cs.submit(r)
    cs.step()
    cs.step()
    assert len(cs._live) == 4
    tokens = np.zeros((4, 1), np.int64)
    pos = np.zeros((4,), np.int64)
    for row, slot in cs._live.items():
        tokens[row, 0] = slot.emitted[-1]
        pos[row] = slot.req.tokens.shape[0] + len(slot.emitted) - 1
    gp.gemm_packed_fused_a.launches = 0
    logits, _ = cs._step(cs.kv.device_tables(), tokens, pos)
    # On the card the step's logits are its graph's static output, which
    # the row steps below overwrite.
    logits = logits.clone()
    launched = gp.gemm_packed_fused_a.launches
    for row in cs._live:
        alone, _ = cs._row_step(row, int(tokens[row, 0]), int(pos[row]))
        assert torch.equal(alone[row], logits[row]), row
    if device == "cuda":
        assert launched == 7 * engine.model.cfg.num_layers + 1


@pytest.mark.parametrize("device", DEVICES)
def test_preempt_resume_bitwise_under_a_small_pool(device):
    engine = _engine(device)
    _, roomy, want = _serve(engine)
    assert roomy["preempted"] == 0 and roomy["completed"] == 8
    cs, tight, got = _serve(engine, num_kv_blocks=10)
    assert tight["completed"] == 8 and tight["evicted"] == 0
    assert tight["preempted"] >= 1 and tight["resumed"] == tight["preempted"]
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("device", DEVICES)
def test_bisection_evicts_exactly_one_row(device):
    engine = _engine(device)
    _, _, want = _serve(engine)
    with faults.inject("batch_step", nth=(1, 2, 3)):
        cs, s, got = _serve(engine, max_retries=1)
    assert s["evicted"] == 1 and s["completed"] == 7
    for rid, res in cs.results.items():
        if res.status == "evicted":
            assert "bisection" in res.detail
        np.testing.assert_array_equal(got[rid], want[rid][:len(got[rid])])
        if res.status == "completed":
            assert len(got[rid]) == len(want[rid])
