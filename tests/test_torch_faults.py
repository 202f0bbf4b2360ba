"""Guarded dispatch of the port (``repro_torch.core.contraction``'s
``fallback_chain`` / ``run_guarded``, the reference lowerings ``torch_ref``
and ``grouped_torch_ref``, the ``pack`` / ``kernel_compile`` /
``kernel_run`` / ``scale_grid`` fault sites, the numerics guard) held to
the JAX package's contract (``tests/test_faults.py``) on the CPU:

  * the chains: the dispatch winner, every other supporting lowering by
    (cost, name) without the comparison lowerings, the reference lowering
    last; packed chains scoped to their weight kind; on the card
    (``on_card``) the winner alone, whose failure raises naming the spec
    and records nothing;
  * auto never picks a reference lowering, on either device;
  * every lowering failing ends at the reference lowering; the last
    entry's failure propagates; contract checks stay before the chain;
  * the numerics guard degrades auto, raises for an explicit choice (and
    for auto on the card) and is off by default; a failed kernel build is
    a ``compile`` failure;
  * a forward that degraded still gives the gradient;
  * ``Engine.health_report()`` surfaces a ``kernel_run`` degradation;
  * parity: ``torch_ref`` / ``grouped_torch_ref`` against ``jnp_ref`` /
    ``grouped_jnp_ref`` on the same numpy inputs, within 1e-5 of max|want|
    in f32 and 1e-2 in bf16, on raw weights, packed float weights, packed
    int8 weights and ragged calls with counts, the port packed by the
    reference's plan. For int4 the reference's reference lowerings unpack
    without the tile format (they read the nibble-packed bytes as int8
    values; ROADMAP.md Queue 3), so the port is held there to the
    reference's ``packed_weight`` lowering, which passes it.

Every test resets the port's fault counters and health registry; the
parity tests reset the JAX package's as well.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ContractionSpec as RefSpec
from repro.core import GroupedPackedWeight as RefGroupedPackedWeight
from repro.core import PackedWeight as RefPackedWeight
from repro.core import contract as ref_contract
from repro.core import health as ref_health
from repro.testing import faults as ref_faults
from repro_torch.configs import reduced_config
from repro_torch.core import contraction as ctr
from repro_torch.core import health, strategy
from repro_torch.core.contraction import LOWERINGS, ContractionSpec, dispatch
from repro_torch.core.gemm import contract, linear
from repro_torch.core.layered import GroupedPackedWeight, PackedWeight
from repro_torch.core.planner import choose_strategy
from repro_torch.interop import _plan as port_plan
from repro_torch.kernels import build
from repro_torch.kernels import pack as pk
from repro_torch.models import build as build_model
from repro_torch.serve import Engine, ServeConfig
from repro_torch.testing import faults

ENV = "REPRO_TORCH_GEMM_STRATEGY"


@pytest.fixture
def no_env(monkeypatch):
    for var in (ENV, "REPRO_GEMM_STRATEGY", "REPRO_GEMM_BACKEND",
                faults.ENV_FAULT, health.ENV_NUMERICS_GUARD):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    ref_faults.reset()
    health.clear_health()
    ref_health.clear_health()
    yield
    health.clear_health()
    ref_health.clear_health()


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _names(chain):
    return [lw.name for lw in chain]


# ---------------------------------------------------------------------------
# Fallback chains
# ---------------------------------------------------------------------------

def test_dense_chain_bottoms_out_at_reference(no_env):
    spec = ContractionSpec.dense(32, 32, 32, "float32")
    names = _names(ctr.fallback_chain(spec, dispatch(spec)))
    assert names == ["torch_matmul", "tiling", "tiling_packing_fused",
                     "torch_ref"]
    assert "naive" not in names                   # comparison-only left out


@pytest.mark.parametrize("m", [4, 512])
def test_dense_chain_on_the_card_runs_the_planners_pick_first(no_env, m):
    """On the card the planner's pick costs 0 and every other contender 1,
    so auto picks the kernel; the chain there is that pick alone."""
    spec = ContractionSpec.dense(m, 2048, 8192, "bfloat16")
    pick = choose_strategy(m, 2048, 8192, "bfloat16")
    assert dispatch(spec, on_card=True).name == pick
    assert _names(ctr.fallback_chain(
        spec, dispatch(spec, on_card=True), on_card=True)) == [pick]


def test_chain_runs_the_registry_as_it_stands(no_env, monkeypatch):
    """The chain's entries are the registry's records when it is built: a
    record swapped in after an earlier call (as chip_smoke's phase 5
    counts lowerings) is the one the chain runs, in the same order."""
    spec = ContractionSpec.dense(16, 32, 24, "float32")
    before = ctr.fallback_chain(spec, dispatch(spec))
    counted = dataclasses.replace(LOWERINGS["tiling"], run=lambda *a, **k: 0)
    monkeypatch.setitem(LOWERINGS, "tiling", counted)
    after = ctr.fallback_chain(spec, dispatch(spec))
    assert _names(after) == _names(before)
    assert after[1] is counted and before[1] is not counted


def test_grouped_chains(no_env):
    plain = ContractionSpec.grouped(2, 16, 32, 32, "float32")
    ragged = ContractionSpec.grouped(2, 16, 32, 32, "float32", counts=True)
    assert _names(ctr.fallback_chain(plain, dispatch(plain))) == [
        "grouped_einsum", "grouped_packed", "grouped_torch_ref"]
    assert _names(ctr.fallback_chain(ragged, dispatch(ragged))) == [
        "grouped_einsum", "grouped_packed_ragged", "grouped_torch_ref"]


def test_packed_chains_are_weight_kind_scoped(no_env, rng):
    pw = PackedWeight.pack(_t(rng.normal(size=(64, 48))))
    gw = GroupedPackedWeight.pack(_t(rng.normal(size=(4, 64, 48))))
    for on_card in (False, True):
        spec = ContractionSpec.dense(8, 64, 48, "float32", w=pw)
        gspec = ContractionSpec.grouped(4, 16, 64, 48, "float32", w=gw)
        tail = (lambda name: [] if on_card else [name])
        assert _names(ctr.fallback_chain(
            spec, dispatch(spec, on_card=on_card), on_card=on_card)) == [
                "packed_weight"] + tail("torch_ref")
        assert _names(ctr.fallback_chain(
            gspec, dispatch(gspec, on_card=on_card), on_card=on_card)) == [
                "grouped_packed_weight"] + tail("grouped_torch_ref")


@pytest.mark.parametrize("on_card", [False, True])
def test_auto_never_picks_reference(no_env, on_card):
    specs = [ContractionSpec.dense(m, 2048, 8192, dt)
             for m in (4, 512) for dt in ("float32", "bfloat16")]
    specs += [ContractionSpec.grouped(8, c, 6144, 16384, "bfloat16",
                                      counts=counts)
              for c in (8, 160) for counts in (False, True)]
    for spec in specs:
        assert not dispatch(spec, on_card=on_card).name.endswith("torch_ref")
    assert ctr.REFERENCE_LOWERINGS == {"dense": "torch_ref",
                                       "grouped": "grouped_torch_ref"}
    assert LOWERINGS["torch_ref"].cost(specs[0], on_card) == ctr.REFERENCE_COST
    assert LOWERINGS["grouped_torch_ref"].cost(specs[-1], on_card) \
        == ctr.REFERENCE_COST


def test_all_lowerings_failing_bottoms_out_at_reference(no_env, rng):
    """Every fault-sited lowering fails (fail-every-hit): the chain walks
    down to torch_ref, which holds no site, and completes."""
    spec = ContractionSpec.dense(16, 32, 24, "float32")
    a, w = _t(rng.normal(size=(16, 32))), _t(rng.normal(size=(32, 24)))
    with faults.inject("kernel_run"):
        out = contract(spec, a, w)
    torch.testing.assert_close(out, a @ w, rtol=1e-5, atol=1e-5)
    degraded = {r.lowering: r.fallback for r in health.HEALTH.records()}
    assert degraded == {"torch_matmul": "tiling",
                        "tiling": "tiling_packing_fused",
                        "tiling_packing_fused": "torch_ref"}


def test_last_chain_entry_failure_propagates(no_env):
    spec = ContractionSpec.dense(16, 32, 24, "float32")
    chain = ctr.fallback_chain(spec, dispatch(spec))

    def run_one(low):
        raise RuntimeError(f"boom in {low.name}")

    with pytest.raises(RuntimeError, match="torch_ref"):
        ctr.run_guarded(spec, chain[0], run_one)
    assert len(health.HEALTH) == len(chain) - 1  # all but the last recorded


def test_the_card_runs_the_winner_alone(no_env):
    """On the card the winner's failure propagates with a note naming the
    spec and the lowering, no other lowering runs, and the registry
    records nothing; a success returns as it is."""
    spec = ContractionSpec.dense(16, 32, 24, "bfloat16")
    winner = dispatch(spec, on_card=True)
    ran = []

    def run_one(low):
        ran.append(low.name)
        raise faults.InjectedFault("kernel_run", 1, "runtime")

    with pytest.raises(faults.InjectedFault) as err:
        ctr.run_guarded(spec, winner, run_one, on_card=True)
    assert ran == [winner.name] and not health.HEALTH
    assert any(spec.describe() in note and winner.name in note
               for note in err.value.__notes__)
    out = torch.ones(2)
    assert ctr.run_guarded(spec, winner, lambda low: out, on_card=True) \
        is out


def test_numerics_guard_raises_for_auto_on_the_card(no_env, monkeypatch):
    """Under the numerics guard a non-finite output of the card's winner
    cannot degrade: it raises NumericsError naming the spec."""
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    spec = ContractionSpec.dense(16, 32, 24, "bfloat16")
    winner = dispatch(spec, on_card=True)
    nan = torch.full((2,), float("nan"))
    with pytest.raises(health.NumericsError, match=winner.name):
        ctr.run_guarded(spec, winner, lambda low: nan, on_card=True)
    assert not health.HEALTH
    # the CPU chain's last entry returns its output as it is
    assert ctr.run_guarded(spec, LOWERINGS["torch_ref"],
                           lambda low: nan) is nan


def test_explicit_strategy_raises_the_fault(no_env, rng):
    spec = ContractionSpec.dense(16, 32, 24, "float32")
    a, w = _t(rng.normal(size=(16, 32))), _t(rng.normal(size=(32, 24)))
    for site in ("kernel_compile", "kernel_run"):
        with faults.inject(site):
            with pytest.raises(faults.InjectedFault):
                contract(spec, a, w, strategy="tiling")
    assert not health.HEALTH


def test_contract_checks_stay_before_the_chain(no_env, rng):
    """Contract violations raise under a fault too, and degrade nothing:
    the silu-gate partner, the ragged shapes, c/alpha/beta on a packed
    weight, a gradient through a packed kernel lowering."""
    gw = GroupedPackedWeight.pack(_t(rng.normal(size=(2, 16, 8))),
                                  n_b_streams=2)
    pw = PackedWeight.pack(_t(rng.normal(size=(16, 8))))
    a3 = _t(rng.normal(size=(2, 4, 16)))
    with faults.inject("kernel_run"):
        with pytest.raises(ValueError, match="partner"):
            gw.matmul(a3, epilogue="silu_gate")
        with pytest.raises(ValueError, match="ragged"):
            gw.matmul(a3, counts=torch.ones(2, 1, dtype=torch.int32))
        with pytest.raises(ValueError, match="silu_gate pair"):
            gw.silu_gate(GroupedPackedWeight.pack(
                _t(rng.normal(size=(2, 16, 8))), n_b_streams=2,
                quantize="int8"), a3)
        with pytest.raises(ValueError, match="no c/alpha/beta"):
            contract(ContractionSpec.dense(4, 16, 8, "float32", w=pw),
                     a3[0], pw, alpha=2.0)
        with pytest.raises(RuntimeError, match="has no backward"):
            linear(a3[0].clone().requires_grad_(True), pw)
    assert not health.HEALTH


def test_degraded_forward_still_gives_the_gradient(no_env, rng):
    """kernel_run's first hit fails the auto pick (torch_matmul) of a
    forward that needs a gradient: the forward degrades to ``tiling``,
    which carries its gradient through ``core.autograd``, and dX / dW /
    dbias equal torch's autograd of the plain product."""
    x = _t(rng.normal(size=(6, 16)))
    w, b = _t(rng.normal(size=(16, 8))), _t(rng.normal(size=(8,)))
    dy = _t(rng.normal(size=(6, 8)))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    with faults.inject("kernel_run", nth=1):
        out = linear(leaves[0], leaves[1], leaves[2], epilogue="gelu")
        got = torch.autograd.grad(out, leaves, dy)
    rec, = health.HEALTH.records()
    assert (rec.lowering, rec.fallback, rec.cause) == (
        "torch_matmul", "tiling", "runtime")
    plain = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want_out = torch.nn.functional.gelu(plain[0] @ plain[1] + plain[2],
                                        approximate="tanh")
    want = torch.autograd.grad(want_out, plain, dy)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-5)


def test_gradient_chain_skips_lowerings_without_a_backward(no_env, rng):
    """Under a gradient a raw grouped chain drops ``grouped_packed`` (no
    backward on the card): every kernel_run failure ends at the plain
    reference, which differentiates."""
    a = _t(rng.normal(size=(2, 4, 16))).requires_grad_(True)
    w = _t(rng.normal(size=(2, 16, 8)))
    spec = ContractionSpec.grouped(2, 4, 16, 8, "float32", w=w)
    with faults.inject("kernel_run"):
        out = contract(spec, a, w)
        (ga,) = torch.autograd.grad(out.sum(), [a])
    degraded = {r.lowering: r.fallback for r in health.HEALTH.records()}
    assert degraded == {"grouped_einsum": "grouped_torch_ref"}
    torch.testing.assert_close(ga, w.sum(-1)[:, None, :].expand(2, 4, 16))


def test_build_failure_classifies_as_compile(no_env, monkeypatch, rng):
    """A failed kernel build carries the ``compile`` class whatever its
    message says, and a guarded contraction records it so."""
    assert health.classify_failure(build.BuildError("exit 1")) == "compile"

    def refuse(*args, **kw):
        raise build.BuildError("kernel build failed: gemm_tiled (exit 1)")

    monkeypatch.setitem(strategy._DENSE, "tiling", refuse)
    monkeypatch.setenv(ENV, "tiling")
    a, w = _t(rng.normal(size=(4, 16))), _t(rng.normal(size=(16, 8)))
    out = contract(ContractionSpec.dense(4, 16, 8, "float32"), a, w)
    torch.testing.assert_close(out, a @ w, rtol=1e-5, atol=1e-5)
    rec, = health.HEALTH.records()
    assert (rec.lowering, rec.cause, rec.fallback) == (
        "tiling", "compile", "torch_matmul")


def test_every_packer_holds_the_pack_site(no_env, rng):
    x = _t(rng.normal(size=(8, 8)))
    for call in (lambda: pk.pack_a(x, 8, 8), lambda: pk.pack_b(x, 8, 8),
                 lambda: pk.pack_b_grouped(x[None], 8, 8)):
        with faults.inject("pack"):
            with pytest.raises(faults.InjectedFault) as err:
                call()
        assert err.value.failure_class == "resource"


# ---------------------------------------------------------------------------
# Numerics guard (opt-in): scale-grid corruption degrades auto, raises
# explicit
# ---------------------------------------------------------------------------

def _quantized(rng):
    w = _t(rng.normal(size=(64, 48)))
    return w, PackedWeight.pack(w, quantize="int8")


def test_numerics_guard_degrades_auto(no_env, monkeypatch, rng):
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    w, pw = _quantized(rng)
    a = _t(rng.normal(size=(8, 64)))
    spec = ContractionSpec.dense(8, 64, 48, "float32", w=pw)
    with faults.inject("scale_grid"):
        out = contract(spec, a, pw)
    # torch_ref dequantizes with the real scale grid: finite, near a @ w
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, a @ w, rtol=0.1, atol=0.5)
    rec, = health.HEALTH.records()
    assert (rec.lowering, rec.cause, rec.fallback) == (
        "packed_weight", "numerics", "torch_ref")


def test_numerics_guard_degrades_a_grouped_pair(no_env, monkeypatch, rng):
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    gate = GroupedPackedWeight.pack(_t(rng.normal(size=(2, 64, 48))),
                                    n_b_streams=2, quantize="int8")
    up = GroupedPackedWeight.pack(_t(rng.normal(size=(2, 64, 48))),
                                  n_b_streams=2, quantize="int8")
    a = _t(rng.normal(size=(2, 1, 8, 64)))
    counts = torch.tensor([[8], [3]], dtype=torch.int32)
    with faults.inject("scale_grid"):
        out = gate.silu_gate(up, a, counts=counts)
    assert bool(torch.isfinite(out).all()) and bool((out[1, 0, 3:] == 0).all())
    rec, = health.HEALTH.records()
    assert (rec.lowering, rec.cause, rec.fallback) == (
        "grouped_packed_weight", "numerics", "grouped_torch_ref")


def test_numerics_guard_raises_for_explicit(no_env, monkeypatch, rng):
    monkeypatch.setenv(health.ENV_NUMERICS_GUARD, "1")
    _, pw = _quantized(rng)
    a = _t(rng.normal(size=(8, 64)))
    spec = ContractionSpec.dense(8, 64, 48, "float32", w=pw)
    with faults.inject("scale_grid"):
        with pytest.raises(health.NumericsError):
            contract(spec, a, pw, strategy="packed_weight")
    assert not health.HEALTH


def test_numerics_guard_off_by_default(no_env, rng):
    """Without REPRO_NUMERICS_GUARD the NaN output passes through (the
    guard reads values back, so it is strictly opt-in)."""
    _, pw = _quantized(rng)
    a = _t(rng.normal(size=(8, 64)))
    spec = ContractionSpec.dense(8, 64, 48, "float32", w=pw)
    with faults.inject("scale_grid"):
        out = contract(spec, a, pw)
    assert bool(torch.isnan(out).all())
    assert not health.HEALTH


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", [False, True])
def test_engine_health_report_surfaces_degradations(no_env, pack):
    """A kernel-run fault during serving: the engine keeps generating, the
    same greedy tokens as without it, and health_report() says why."""
    cfg = dataclasses.replace(reduced_config("olmo-1b"),
                              compute_dtype="float32", vocab_size=64)
    model = build_model(cfg, device="cpu")
    engine = Engine(model, model.init(0),
                    ServeConfig(max_len=32, pack_weights=pack), device="cpu")
    assert engine.health_report() == {}   # healthy before any fault
    tokens = torch.zeros((2, 8), dtype=torch.long)
    want = engine.generate({"tokens": tokens}, max_new_tokens=2)
    with faults.inject("kernel_run"):
        out = engine.generate({"tokens": tokens}, max_new_tokens=2)
    assert out.shape == (2, 2)
    np.testing.assert_array_equal(out, want)
    report = engine.health_report()
    assert report, "degradations must surface through the engine"
    for entry in report.values():
        assert entry["cause"] == "runtime" and entry["count"] >= 1
        assert entry["fallback"] in ("torch_ref", "tiling",
                                     "tiling_packing_fused")


# ---------------------------------------------------------------------------
# Parity: the reference lowerings against the JAX package's
# ---------------------------------------------------------------------------

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _close(got, want, dtype):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL[dtype], (err, TOL[dtype])


def _pair(x, dtype):
    """The same numpy values in both packages, rounded once to ``dtype``."""
    return jnp.asarray(x, jnp.dtype(dtype)), _t(x, getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "bias_gelu", "gemm_c"])
def test_torch_ref_matches_jnp_ref_on_raw_weights(no_env, rng, dtype, case):
    a_np, w_np = rng.normal(size=(2, 5, 40)), rng.normal(size=(40, 24))
    b_np, c_np = rng.normal(size=(24,)), rng.normal(size=(10, 24))
    (ja, ta), (jw, tw) = _pair(a_np, dtype), _pair(w_np, dtype)
    if case == "gemm_c":
        (jc, tc) = _pair(c_np, dtype)
        kw = dict(alpha=0.5, beta=2.0)
        want = ref_contract(RefSpec.dense(10, 40, 24, dtype, accum="f32"),
                            ja.reshape(10, 40), jw, c=jc,
                            strategy="jnp_ref", **kw)
        got = contract(ContractionSpec.dense(10, 40, 24, dtype, accum="f32"),
                       ta.reshape(10, 40), tw, c=tc, strategy="torch_ref",
                       **kw)
    else:
        epi = "none" if case == "plain" else "bias_gelu"
        (jb, tb) = _pair(b_np, dtype) if case != "plain" else (None, None)
        want = ref_contract(RefSpec.dense(10, 40, 24, dtype, epilogue=epi,
                                          bias=jb is not None),
                            ja, jw, bias=jb, strategy="jnp_ref")
        got = contract(ContractionSpec.dense(10, 40, 24, dtype, epilogue=epi,
                                             bias=tb is not None),
                       ta, tw, bias=tb, strategy="torch_ref")
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [None, "int8", "int8:col"])
def test_torch_ref_matches_jnp_ref_on_packed_weights(no_env, rng, dtype,
                                                     quantize):
    """The port packs by the reference's plan (its planner's tiles, its
    quantizer's format), so both reference lowerings unpack the same
    tiles."""
    a_np, w_np = rng.normal(size=(6, 96)), rng.normal(size=(96, 80))
    b_np = rng.normal(size=(80,))
    (ja, ta), (jb, tb) = _pair(a_np, dtype), _pair(b_np, dtype)
    jw = jnp.asarray(w_np, jnp.float32 if quantize else jnp.dtype(dtype))
    jpw = RefPackedWeight.pack(jw, quantize=quantize, backend="jnp")
    tpw = PackedWeight.pack(_t(w_np, torch.float32 if quantize
                               else getattr(torch, dtype)),
                            plan=port_plan(jpw.plan), quantize=quantize)
    want = ref_contract(RefSpec.dense(6, 96, 80, dtype, w=jpw,
                                      epilogue="relu", bias=True),
                        ja, jpw, bias=jb, strategy="jnp_ref")
    got = contract(ContractionSpec.dense(6, 96, 80, dtype, w=tpw,
                                         epilogue="relu", bias=True),
                   ta, tpw, bias=tb, strategy="torch_ref")
    _close(got, want, dtype)


@pytest.mark.parametrize("quantize", ["int4", "int4:col"])
def test_torch_ref_on_int4_weights_matches_the_reference(no_env, rng,
                                                         quantize):
    """int4: the reference's ``packed_weight`` lowering (jnp backend, which
    widens the nibbles by the tile format) is the yardstick, dense and
    grouped."""
    a_np, w_np = rng.normal(size=(6, 128)), rng.normal(size=(128, 80))
    ja, ta = _pair(a_np, "float32")
    jpw = RefPackedWeight.pack(jnp.asarray(w_np, jnp.float32),
                               quantize=quantize, backend="jnp")
    tpw = PackedWeight.pack(_t(w_np), plan=port_plan(jpw.plan),
                            quantize=quantize)
    want = ref_contract(RefSpec.dense(6, 128, 80, "float32", w=jpw), ja, jpw,
                        strategy="packed_weight")
    got = contract(ContractionSpec.dense(6, 128, 80, "float32", w=tpw), ta,
                   tpw, strategy="torch_ref")
    _close(got, want, "float32")
    g_np, a3_np = rng.normal(size=(2, 128, 80)), rng.normal(size=(2, 4, 128))
    jg = RefGroupedPackedWeight.pack(jnp.asarray(g_np, jnp.float32),
                                     quantize=quantize, backend="jnp")
    tg = GroupedPackedWeight.pack(_t(g_np), plan=port_plan(jg.plan),
                                  quantize=quantize)
    (ja3, ta3) = _pair(a3_np, "float32")
    want = ref_contract(RefSpec.grouped(2, 4, 128, 80, "float32", w=jg), ja3,
                        jg, strategy="grouped_packed_weight")
    got = contract(ContractionSpec.grouped(2, 4, 128, 80, "float32", w=tg),
                   ta3, tg, strategy="grouped_torch_ref")
    _close(got, want, "float32")


def _grouped_operands(rng, dtype, packed, quantize, counts, pair):
    e, s, c, k, n = 3, 2, 5, 64, 48
    a_np = rng.normal(size=(s, e, c, k))
    ws = [rng.normal(size=(e, k, n)) for _ in range(2 if pair else 1)]
    cnt = rng.integers(0, c + 1, size=(s, e)) if counts else None
    (ja, ta) = _pair(a_np, dtype)
    jws, tws = [], []
    for w_np in ws:
        if packed:
            jw = RefGroupedPackedWeight.pack(
                jnp.asarray(w_np, jnp.float32 if quantize
                            else jnp.dtype(dtype)),
                n_b_streams=2 if pair else 1, quantize=quantize,
                backend="jnp")
            tw = GroupedPackedWeight.pack(
                _t(w_np, torch.float32 if quantize
                   else getattr(torch, dtype)),
                plan=port_plan(jw.plan), quantize=quantize)
        else:
            jw, tw = _pair(w_np, dtype)
        jws.append(jw)
        tws.append(tw)
    jc = None if cnt is None else jnp.asarray(cnt, jnp.int32)
    tc = None if cnt is None else torch.from_numpy(cnt).to(torch.int32)
    return (e, c * s, k, n), (ja, jws, jc), (ta, tws, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["raw", "packed", "int8"])
@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_grouped_torch_ref_matches_grouped_jnp_ref(no_env, rng, dtype,
                                                   weights, counts, pair):
    """Raw stacks, packed float and int8 stacks, with and without counts
    (the masked oracle), one stack or the silu-gate pair."""
    geo, (ja, jws, jc), (ta, tws, tc) = _grouped_operands(
        rng, dtype, weights != "raw", "int8" if weights == "int8" else None,
        counts, pair)
    e, m, k, n = geo
    epi = "silu_gate" if pair else "gelu"
    jspec = RefSpec.grouped(e, m, k, n, dtype, w=jws[0], epilogue=epi,
                            counts=counts)
    tspec = ContractionSpec.grouped(e, m, k, n, dtype, w=tws[0],
                                    epilogue=epi, counts=counts)
    want = ref_contract(jspec, ja, jws[0], w2=jws[1] if pair else None,
                        counts=jc, strategy="grouped_jnp_ref")
    got = contract(tspec, ta, tws[0], w2=tws[1] if pair else None,
                   counts=tc, strategy="grouped_torch_ref")
    _close(got, want, dtype)
    if counts:
        dead = np.arange(ta.shape[2])[None, None, :] >= tc.numpy()[..., None]
        assert bool((got.to(torch.float32).numpy()[dead] == 0).all())
