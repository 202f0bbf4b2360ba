"""The port's public GEMM surface against the JAX reference on the CPU: the
grouped facades (``grouped_linear`` / ``grouped_silu_gate``), ``LayeredGemm``,
``apply_epilogue``, ``all_configs``, the grouped oracles and
``unpack_b_grouped``, on the same numpy inputs; then the four example entry
points (``examples/torch_*.py``) at a tiny size with ``--device cpu``.

The reference runs its Pallas kernels in interpret mode
(``backend="pallas"``), ``LayeredGemm`` on its jnp backend. Tolerances: f32
1e-5 (the same f32 products summed in other orders), bf16 2e-2 (outputs
rounded to bf16 after f32 sums in other orders)."""
import importlib.util
import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as rcore
import repro_torch.core as tcore
from repro.configs import all_configs as ref_all_configs
from repro.core.epilogue import apply_epilogue as ref_apply_epilogue
from repro.kernels import ref as rref
from repro.kernels.gemm_grouped import unpack_b_grouped as ref_unpack_grouped
from repro_torch.configs import all_configs, reduced_config
from repro_torch.core.epilogue import ACTIVATIONS, apply_epilogue
from repro_torch.kernels import ref as tref
from repro_torch.kernels.gemm_grouped import unpack_b_grouped

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REF_NAME = {"torch_matmul": "xla"}      # the port's rename of the library proxy

# reduced mixtral-8x22b's expert geometry: d_model 64, d_ff 128, 4 experts
MIX = reduced_config("mixtral-8x22b")
E, D, F = MIX.num_experts, MIX.d_model, MIX.d_ff
G, C = 2, 8                              # routing groups, capacity
# one expert empty and one full in each group, the rest partial
COUNTS = np.array([[0, C, 3, 5], [C, 1, 0, 6]], np.int32)


def _np(x):
    return x.to(torch.float32).numpy() if torch.is_tensor(x) else \
        np.asarray(x, dtype=np.float32)


def _grouped_inputs(dtype):
    """x [G, E, C, D], the gate / up stacks [E, D, F] and a bias [E, F], as
    numpy in ``dtype``'s precision."""
    rng = np.random.default_rng(11)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)) \
        if dtype == "bfloat16" else (lambda a: a)
    x = cast(rng.normal(size=(G, E, C, D)).astype(np.float32))
    wg, wu = (cast((rng.normal(size=(E, D, F)) * 0.1).astype(np.float32))
              for _ in range(2))
    bias = cast(rng.normal(size=(E, F)).astype(np.float32))
    return x, wg, wu, bias


def _both(arr, dtype):
    """``arr`` as (a jnp array, a torch tensor), both in ``dtype``."""
    return (jnp.asarray(arr).astype(JDT[dtype]),
            torch.from_numpy(np.ascontiguousarray(arr)).to(TDT[dtype]))


def _stacks(weight, wg, wu, dtype):
    """The gate / up stacks as (reference, port) pairs: raw, or packed as a
    silu-gate pair sharing one plan."""
    (jg, tg), (ju, tu) = _both(wg, dtype), _both(wu, dtype)
    if weight == "raw":
        return (jg, tg), (ju, tu)
    rg = rcore.GroupedPackedWeight.pack(jg, n_b_streams=2, backend="pallas")
    ru = rcore.GroupedPackedWeight.pack(ju, plan=rg.plan, backend="pallas")
    pg = tcore.GroupedPackedWeight.pack(tg, n_b_streams=2)
    pu = tcore.GroupedPackedWeight.pack(tu, plan=pg.plan)
    return (rg, pg), (ru, pu)


# (weight kind, strategy, ragged): every grouped strategy by name, with and
# without counts where it takes them, and the auto pick
GROUPED_CASES = [
    ("raw", "auto", False), ("raw", "auto", True),
    ("raw", "grouped_einsum", False), ("raw", "grouped_einsum", True),
    ("raw", "grouped_packed", False), ("raw", "grouped_packed_ragged", True),
    ("packed", "auto", False), ("packed", "auto", True),
    ("packed", "grouped_packed_weight", False),
    ("packed", "grouped_packed_weight", True),
]


def _check_ragged_rows(out):
    """Rows at or past each (group, expert)'s count are exactly 0."""
    dead = np.arange(C)[None, None, :] >= COUNTS[..., None]
    assert not _np(out)[dead].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight,strategy,ragged", GROUPED_CASES)
def test_grouped_silu_gate_matches_reference(weight, strategy, ragged, dtype):
    x, wg, wu, _ = _grouped_inputs(dtype)
    jx, tx = _both(x, dtype)
    (rg, pg), (ru, pu) = _stacks(weight, wg, wu, dtype)
    kw_r = dict(counts=jnp.asarray(COUNTS)) if ragged else {}
    kw_t = dict(counts=torch.from_numpy(COUNTS)) if ragged else {}
    want = rcore.grouped_silu_gate(jx, rg, ru, strategy=strategy,
                                   backend="pallas", **kw_r)
    got = tcore.grouped_silu_gate(tx, pg, pu, strategy=strategy, **kw_t)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (G, E, C, F)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if ragged:
        _check_ragged_rows(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight,strategy,ragged", GROUPED_CASES)
def test_grouped_linear_matches_reference(weight, strategy, ragged, dtype):
    """``grouped_linear`` with a bias and gelu on the gate stack (the
    reference's ``bias_gelu`` chain)."""
    x, wg, wu, bias = _grouped_inputs(dtype)
    jx, tx = _both(x, dtype)
    jb, tb = _both(bias, dtype)
    if weight == "raw":
        rw, pw = _both(wg, dtype)
    else:
        rw = rcore.GroupedPackedWeight.pack(_both(wg, dtype)[0],
                                            backend="pallas")
        pw = tcore.GroupedPackedWeight.pack(_both(wg, dtype)[1])
    kw_r = dict(counts=jnp.asarray(COUNTS)) if ragged else {}
    kw_t = dict(counts=torch.from_numpy(COUNTS)) if ragged else {}
    want = rcore.grouped_linear(jx, rw, jb, strategy=strategy,
                                backend="pallas",
                                epilogue=rcore.EPILOGUE_SPECS["gelu"], **kw_r)
    got = tcore.grouped_linear(tx, pw, tb, strategy=strategy,
                               epilogue="gelu", **kw_t)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (G, E, C, F)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if ragged:
        _check_ragged_rows(got)


@pytest.mark.parametrize("packed", ["gate", "up"])
def test_grouped_silu_gate_refuses_a_packed_raw_pair(packed):
    """One stack packed and the other raw raises, as the reference does."""
    x, wg, wu, _ = _grouped_inputs("float32")
    tx = torch.from_numpy(x)
    tg, tu = torch.from_numpy(wg), torch.from_numpy(wu)
    if packed == "gate":
        tg = tcore.GroupedPackedWeight.pack(tg, n_b_streams=2)
    else:
        tu = tcore.GroupedPackedWeight.pack(tu)
    with pytest.raises(ValueError, match="both packed or both raw"):
        tcore.grouped_silu_gate(tx, tg, tu)
    jg, ju = jnp.asarray(wg), jnp.asarray(wu)
    if packed == "gate":
        jg = rcore.GroupedPackedWeight.pack(jg, n_b_streams=2, backend="jnp")
    else:
        ju = rcore.GroupedPackedWeight.pack(ju, backend="jnp")
    with pytest.raises(ValueError, match="both packed or both raw"):
        rcore.grouped_silu_gate(jnp.asarray(x), jg, ju, backend="jnp")


def test_grouped_linear_leading_dims_fold_into_m():
    """[*lead, E, M, K] with two leading dims: the same as the rows laid out
    as one leading dim, on a kernel lowering that folds them."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, E, 4, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(E, D, F)) * 0.1).astype(np.float32))
    got = tcore.grouped_linear(x, w, strategy="grouped_packed")
    flat = tcore.grouped_linear(x.reshape(6, E, 4, D), w,
                                strategy="grouped_einsum")
    torch.testing.assert_close(got.reshape(6, E, 4, F), flat, **TOL["float32"])


# -- LayeredGemm ----------------------------------------------------------------

LG_SHAPE = (48, 96, 80)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", list(tcore.STRATEGIES) + [None])
def test_layered_gemm_matches_reference(strategy, dtype):
    """``LayeredGemm`` per strategy (``None``: the planner's pick) with a
    bias and relu, three calls on one object, against the reference's
    ``LayeredGemm(backend="jnp")`` under the same strategy; the plan is
    solved once and kept."""
    m, k, n = LG_SHAPE
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=s).astype(np.float32) for s in ((m, k), (k, n)))
    bias = rng.normal(size=n).astype(np.float32)
    lg = tcore.LayeredGemm(m, k, n, dtype, strategy=strategy, epilogue="relu")
    assert lg.strategy == (strategy or tcore.choose_strategy(m, k, n, dtype))
    rl = rcore.LayeredGemm(m, k, n, dtype,
                           strategy=REF_NAME.get(lg.strategy, lg.strategy),
                           backend="jnp", epilogue="relu")
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    want = rl(ja, jb, bias=jnp.asarray(bias))
    plan = lg.plan
    for _ in range(3):
        got = lg(ta, tb, bias=torch.from_numpy(bias))
        assert lg.plan is plan and got.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def test_layered_gemm_checks_shapes_and_keeps_a_given_plan():
    plan = tcore.plan_gemm(16, 32, 24, "float32")
    lg = tcore.LayeredGemm(16, 32, 24, plan=plan, strategy="tiling")
    assert lg.plan is plan
    with pytest.raises(AssertionError):
        lg(torch.zeros(16, 31), torch.zeros(31, 24))


# -- epilogues, configs, oracles, unpack ---------------------------------------

@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_apply_epilogue_matches_reference(name):
    x = np.linspace(-4, 4, 257, dtype=np.float32)
    want = np.asarray(ref_apply_epilogue(name, jnp.asarray(x)))
    got = apply_epilogue(name, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name == "gelu":
        # torch's default (erf) gelu is not the reference's: on these
        # inputs it differs by far more than the tolerance above
        erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        assert np.abs(erf - want).max() > 1e-4
    with pytest.raises(KeyError):
        apply_epilogue("swish", torch.from_numpy(x))


def test_all_configs_match_reference():
    ref = ref_all_configs()
    port = all_configs()
    assert [c.name for c in port] == [c.name for c in ref]
    for r, p in zip(ref, port):
        assert (p.num_layers, p.d_model, p.d_ff, p.num_experts) == \
            (r.num_layers, r.d_model, r.d_ff, r.num_experts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["grouped_matmul_ref",
                                    "grouped_silu_gate_ref"])
def test_grouped_oracles_match_reference(oracle, dtype):
    x, wg, wu, _ = _grouped_inputs(dtype)
    a = x.reshape(E * G, C, D)[:E]
    args = (a, wg, wu) if oracle == "grouped_silu_gate_ref" else (a, wg)
    want = getattr(rref, oracle)(*(_both(v, dtype)[0] for v in args))
    got = getattr(tref, oracle)(*(_both(v, dtype)[1] for v in args))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("fmt", [("float32", None, "row"),
                                 ("int8", "tile", "row"),
                                 ("int4", "col", "col")],
                         ids=["float32", "int8:tile", "int4:col"])
def test_unpack_b_grouped_matches_reference(fmt):
    """A stack packed by the port's packer (byte-identical to the
    reference's), unpacked by both: the same natural [E, K, N], dequantized
    where the format is quantized (int4 widened from its nibbles first)."""
    from repro.core import tile_format as rtf
    from repro_torch.core import tile_format as ttf
    dtype, gran, layout = fmt
    fmts = [mod.TileFormat(bk=64, bn=64, layout=layout, dtype=dtype,
                           scale=None if gran is None
                           else mod.ScaleSpec(granularity=gran))
            for mod in (rtf, ttf)]
    rng = np.random.default_rng(9)
    w = rng.normal(size=(E, 100, 72)).astype(np.float32)
    packed = tref.pack_b_grouped_ref(torch.from_numpy(w), fmts[1])
    bp, scales = packed if isinstance(packed, tuple) else (packed, None)
    want = ref_unpack_grouped(
        jnp.asarray(bp.numpy()), 100, 72, layout,
        scales=None if scales is None else jnp.asarray(scales.numpy()),
        fmt=fmts[0])
    got = unpack_b_grouped(bp, 100, 72, layout, scales=scales, fmt=fmts[1])
    assert tuple(got.shape) == (E, 100, 72)
    np.testing.assert_array_equal(_np(got), _np(want))
    if scales is None:
        np.testing.assert_array_equal(got.numpy(), w)
    else:   # the dequantized stack is the weight up to its quantization step
        assert np.abs(got.numpy() - w).max() < 0.6


# -- the example entry points ---------------------------------------------------

ERR_LINE = re.compile(r"max\|err\| = ([0-9.e+-]+) \(gate ([0-9.e+-]+)\)")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _errors(text):
    """Every ``max|err| = E (gate G)`` pair an example printed."""
    return [(float(e), float(g)) for e, g in ERR_LINE.findall(text)]


def test_quickstart_example_on_the_cpu(capsys):
    assert _example("torch_quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    errs = _errors(out)
    # nine capable lowerings, bias_gelu, LayeredGemm, PackedWeight
    assert len(errs) == 12 and all(e <= g for e, g in errs), errs
    assert "dispatch picks: packed_weight" in out


def test_gemm_strategies_example_on_the_cpu(capsys):
    mod = _example("torch_gemm_strategies")
    assert mod.main(["--device", "cpu", "--sizes", "16,32", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    errs = _errors(out)
    assert len(errs) == 2 and all(e <= g for e, g in errs), errs
    assert out.count("auto=torch_matmul") == 2


def test_gemm_strategies_example_counts_a_nan_as_an_error(capsys,
                                                         monkeypatch):
    """A strategy whose output is NaN fails the row, whatever order the
    strategies' errors are taken in."""
    mod = _example("torch_gemm_strategies")
    real = mod.contract

    def poisoned(spec, a, b, strategy):
        out = real(spec, a, b, strategy=strategy)
        return out.fill_(float("nan")) if strategy == "vsx" else out
    monkeypatch.setattr(mod, "contract", poisoned)
    assert mod.main(["--device", "cpu", "--sizes", "16", "--reps", "1"]) == 1
    assert "max|err| = inf" in capsys.readouterr().out


@pytest.mark.parametrize("mode", [[], ["--pack-weights"],
                                  ["--stream", "--batch", "5"],
                                  ["--stream", "--continuous", "--batch", "5"]],
                         ids=["batch", "packed", "stream", "continuous"])
def test_serve_example_on_the_cpu(capsys, mode):
    mod = _example("torch_serve_lm")
    argv = ["--device", "cpu", "--arch", "olmo-1b", "--batch", "2", "--new",
            "3", "--prompt-len", "6", *mode]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    assert "health_report: {} (healthy: no degraded lowerings)" in out
    if "--stream" in mode:
        assert "lifecycle counters:" in out and " completed " in out
    else:
        rows = re.findall(r"req\d: \[([0-9, ]+)\]", out)
        assert len(rows) == 2 and all(len(r.split(",")) == 3 for r in rows)


def test_train_example_on_the_cpu(capsys, tmp_path):
    mod = _example("torch_train_lm")
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps" in out
    assert sorted(os.listdir(tmp_path))   # the final checkpoint was written
    assert mod.with_defaults([])[:2] == ["--steps", "200"]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_lm",
                                  "torch_train_lm", "torch_gemm_strategies"])
def test_examples_refuse_a_missing_card(name, monkeypatch):
    """Without a card and without ``--device cpu`` each entry point exits at
    once, naming the device; nothing runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _example(name)
    with pytest.raises(SystemExit) as exc:
        mod.main([])
    assert "--device cuda needs a CUDA device" in str(exc.value.code)
    assert "--device cpu" in str(exc.value.code)
