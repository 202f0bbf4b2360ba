"""Port vs reference: the packed-weight serving slice on reduced olmo-1b.

The reference's ``init_params`` tree crosses to the port through numpy
(``repro_torch.interop``); both engines pack it with their own packers and
are driven step by step on the same prompt."""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import build as ref_build
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import strategy as tstrat
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import serving_dispatch_report

torch.set_num_threads(1)


def _engines(compute, pack=True, scale=1.0, **serve):
    ref_cfg = dataclasses.replace(ref_reduced_config("olmo-1b"),
                                  compute_dtype=compute)
    ref_model = ref_build(ref_cfg)
    tree = jax.tree.map(lambda x: np.asarray(x) * scale,
                        ref_model.init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(reduced_config("olmo-1b"), compute_dtype=compute)
    ref_engine = RefEngine(ref_model, jax.tree.map(jnp.asarray, tree),
                           RefServeConfig(max_len=32, pack_weights=pack,
                                          **serve))
    model = build(cfg, device="cpu")
    engine = Engine(model, params_from_numpy(tree, cfg, "cpu"),
                    ServeConfig(max_len=32, pack_weights=pack, **serve),
                    device="cpu")
    return ref_engine, engine


def _step_logits(ref_engine, engine, prompt, steps):
    """Prefill + greedy decode on both engines; per-step logits and tokens."""
    lr, cr = ref_engine._prefill(ref_engine.params,
                                 {"tokens": jnp.asarray(prompt)})
    lp, cp = engine._prefill(
        {"tokens": torch.as_tensor(prompt, dtype=torch.long)})
    out = [(np.asarray(lr), lp.numpy())]
    tr = jnp.argmax(lr, -1).astype(jnp.int32)[:, None]
    tp = torch.argmax(lp, -1)[:, None]
    toks = [(np.asarray(tr), tp.numpy())]
    b, s = prompt.shape
    for i in range(steps):
        lr, cr = ref_engine._decode(ref_engine.params, cr, tr,
                                    jnp.full((b,), s + i, jnp.int32))
        lp, cp = engine._decode(cp, tp, torch.full((b,), s + i,
                                                   dtype=torch.long))
        out.append((np.asarray(lr[:, 0]), lp[:, 0].numpy()))
        tr = jnp.argmax(lr[:, 0], -1).astype(jnp.int32)[:, None]
        tp = torch.argmax(lp[:, 0], -1)[:, None]
        toks.append((np.asarray(tr), tp.numpy()))
    return out, toks


# scale=4 multiplies every reference weight (both sides get the same tree)
# so that greedy decoding wanders over the vocabulary instead of repeating
# one token.
@pytest.mark.parametrize("pack,scale", [(True, 1.0), (True, 4.0),
                                        (False, 4.0)])
def test_f32_logits_and_greedy_tokens_match_reference(pack, scale):
    """f32: prefill and every decode step's logits within atol=1e-4 (same
    products, different summation orders); greedy tokens identical over 8
    steps."""
    ref_engine, engine = _engines("float32", pack=pack, scale=scale)
    prompt = np.random.default_rng(0).integers(0, 256, (2, 6)).astype(np.int32)
    logits, toks = _step_logits(ref_engine, engine, prompt, 8)
    for want, got in logits:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for want, got in toks:
        np.testing.assert_array_equal(got, want)
    got = engine.generate({"tokens": prompt}, 8)
    np.testing.assert_array_equal(
        got, ref_engine.generate({"tokens": jnp.asarray(prompt)}, 8))
    if scale > 1:
        assert len(np.unique(got)) > 2


@pytest.mark.parametrize("strategy", ["tiling", "tiling_packing_fused"])
def test_raw_weights_through_the_card_strategies_match_reference(
        strategy, monkeypatch):
    """Raw-weight serving (the default ServeConfig) through the two
    lowerings the planner picks on the card — ``tiling`` (K7) at decode,
    ``tiling_packing_fused`` (K5 + K1) at prefill — forced for every
    contraction with REPRO_TORCH_GEMM_STRATEGY (on CPU tensors the kernels
    run their plain versions): f32 logits within atol=1e-4 of the
    reference's and its greedy tokens, with every contraction of every
    forward through the forced strategy."""
    calls = []
    real = tstrat._DENSE[strategy]
    monkeypatch.setitem(tstrat._DENSE, strategy,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv("REPRO_TORCH_GEMM_STRATEGY", strategy)
    ref_engine, engine = _engines("float32", pack=False, scale=4.0)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 6)).astype(np.int32)
    logits, toks = _step_logits(ref_engine, engine, prompt, 6)
    for want, got in logits:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for want, got in toks:
        np.testing.assert_array_equal(got, want)
    cfg = reduced_config("olmo-1b")
    assert len(calls) == (7 * cfg.num_layers + 1) * 7   # prefill + 6 steps


def test_raw_dispatch_report_on_the_card():
    """Raw olmo-1b weights on the card: the LM head lowers to K5 + K1 at a
    prefill of max_len rows and to K7 at decode; on the CPU to torch."""
    cfg = get_config("olmo-1b")
    report = serving_dispatch_report(cfg, ServeConfig(max_len=512), {},
                                     on_card=True)
    assert sorted(report.values()) == ["tiling", "tiling_packing_fused"]
    assert [k.split(":")[0] for k, v in report.items()
            if v == "tiling"] == ["lm_head.decode"]
    cpu = serving_dispatch_report(cfg, ServeConfig(max_len=512), {})
    assert set(cpu.values()) == {"torch_matmul"}


def test_bf16_logits_match_reference():
    """bf16 compute: every activation is rounded to bf16 at a few places
    that the two frameworks order differently; logits of magnitude ~1 agree
    within atol=5e-2 at prefill and over 4 decode steps."""
    ref_engine, engine = _engines("bfloat16", scale=4.0)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 6)).astype(np.int32)
    logits, _ = _step_logits(ref_engine, engine, prompt, 4)
    np.testing.assert_allclose(logits[0][1], logits[0][0], rtol=0, atol=5e-2)
    for want, got in logits[1:]:
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_sampled_stream_is_independent_of_batch_neighbours():
    """A row's sampled tokens depend on (seed, request_id, step) only."""
    _, engine = _engines("float32", scale=4.0, temperature=1.0, seed=3)
    rng = np.random.default_rng(2)
    p1, p2 = (rng.integers(0, 256, (1, 6)).astype(np.int32) for _ in range(2))
    solo = engine.generate({"tokens": p1}, 6, request_ids=[7])
    batched = engine.generate({"tokens": np.concatenate([p2, p1])}, 6,
                              request_ids=[11, 7])
    np.testing.assert_array_equal(batched[1:], solo)
    logits = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    alone = engine.sample_tokens(logits[1:2], [5], 4)
    mixed = engine.sample_tokens(logits, [9, 5, 1], 4)
    assert int(alone[0]) == int(mixed[1])
    draws = {int(engine.sample_tokens(logits[1:2], [5], s)[0]) for s in range(8)}
    assert len(draws) > 1  # the step enters the stream


def test_dispatch_report_names_the_lowerings():
    _, packed = _engines("float32")
    _, raw = _engines("float32", pack=False)
    assert set(packed.dispatch_report.values()) == {"packed_weight"}
    assert set(raw.dispatch_report.values()) == {"torch_matmul"}
    assert len(packed.dispatch_report) == 2


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    cfg = reduced_config("olmo-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(cfg)
    model = build(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, model.init(0), ServeConfig(max_len=16))


def test_port_imports_no_jax_and_nothing_of_the_reference():
    code = ("import sys, chip_smoke, repro_torch.interop, repro_torch.serve, "
            "repro_torch.kernels.build, repro_torch.models.moe, "
            "repro_torch.kernels.gemm_grouped, repro_torch.kernels.pack, "
            "repro_torch.kernels.gemm_tiled, repro_torch.kernels.gemm_vsx_like, "
            "repro_torch.core.strategy, repro_torch.core;"
            "from repro_torch.core import matmul, STRATEGIES;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": "src:.", "PATH": "/usr/bin:/bin"})
