"""Port vs reference: the paper's lowering strategies, the GEMM facade and
the dispatch rule. Every dense strategy of ``repro_torch.core.strategy``
(plain torch versions of the kernels on CPU tensors) against the
reference's ``repro.core.strategy.run(..., backend="pallas")`` (Pallas in
interpret mode) on the same numpy inputs; every grouped strategy on raw
expert stacks the same way. Tolerances: f32 rtol = atol = 1e-5 (the same
f32 products, summed in other orders), bf16 rtol = atol = 1e-2 (outputs
rounded to bf16 after f32 sums taken in other orders: one bf16 ulp is
2^-8 relative), int8 -> int32 exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EPILOGUE_SPECS as REF_EPILOGUES
from repro.core import strategy as rstrat
from repro.core.gemm import matmul as ref_matmul
from repro_torch.core import contraction as ctr
from repro_torch.core import gemm as tgemm
from repro_torch.core import planner as tplan
from repro_torch.core import strategy as tstrat
from repro_torch.core.contraction import ContractionSpec
from repro_torch.core.layered import PackedWeight

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)
SHAPES = [(33, 65, 17), (64, 128, 96)]
REF_NAME = {"torch_matmul": "xla"}   # the reference's library proxy
EPILOGUES = ["none", "relu", "gelu", "silu", "tanh"]


def _np(x):
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def _data(m, k, n, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (rng.integers(-100, 100, (m, k)).astype(np.int8),
                rng.integers(-100, 100, (k, n)).astype(np.int8),
                rng.integers(-1000, 1000, (m, n)).astype(np.int32),
                rng.integers(-100, 100, n).astype(np.int32))
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _both(strategy, a, b, c=None, bias=None, *, dtype="float32", **kw):
    """(port output, reference output) as numpy, on the same inputs."""
    jdt = {"bfloat16": jnp.bfloat16}.get(dtype)
    tdt = {"bfloat16": torch.bfloat16}.get(dtype)

    def j(x):
        x = jnp.asarray(x)
        return x.astype(jdt) if jdt is not None and x.ndim == 2 and \
            x.dtype == jnp.float32 else x

    def t(x):
        x = torch.from_numpy(x)
        return x.to(tdt) if tdt is not None and x.dim() == 2 and \
            x.dtype == torch.float32 else x
    ref_out, port_out = kw.pop("ref_out_dtype", None), kw.pop(
        "port_out_dtype", None)
    want = rstrat.run(REF_NAME.get(strategy, strategy), j(a), j(b),
                      None if c is None else j(c), backend="pallas",
                      interpret=True,
                      bias=None if bias is None else jnp.asarray(bias),
                      out_dtype=ref_out, **kw)
    got = tstrat.run(strategy, t(a), t(b), None if c is None else t(c),
                     bias=None if bias is None else torch.from_numpy(bias),
                     out_dtype=port_out, **kw)
    return _np(got), np.asarray(want, dtype=np.float32) \
        if dtype == "bfloat16" else np.asarray(want)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("strategy", tstrat.STRATEGIES)
def test_dense_strategy_with_c_alpha_beta_and_bias(strategy, m, k, n):
    a, b, c, bias = _data(m, k, n)
    got, want = _both(strategy, a, b, c, bias, alpha=1.5, beta=0.5,
                      epilogue="gelu")
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("strategy", ["intrinsic", "tiling", "tiling_packing",
                                      "tiling_packing_fused", "vsx"])
def test_dense_kernel_strategies_every_epilogue(strategy, epilogue):
    a, b, _, bias = _data(33, 65, 17, seed=1)
    got, want = _both(strategy, a, b, bias=bias, epilogue=epilogue)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("strategy", tstrat.STRATEGIES)
def test_dense_strategy_bf16(strategy):
    a, b, _, _ = _data(33, 65, 17, seed=2)
    got, want = _both(strategy, a, b, dtype="bfloat16")
    np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("strategy", tstrat.STRATEGIES)
def test_dense_strategy_int8_is_exact(strategy):
    a, b, c, bias = _data(33, 65, 17, seed=3, dtype="int8")
    got, want = _both(strategy, a, b, ref_out_dtype=jnp.int32,
                      port_out_dtype=torch.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, a.astype(np.int64) @ b.astype(np.int64))


# -- grouped lowerings on raw expert stacks ------------------------------

def _grouped_data(e=3, s=2, c=12, k=40, n=24, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((e, s * c, k)).astype(np.float32)
    b, b2 = (rng.standard_normal((e, k, n)).astype(np.float32) * 0.3
             for _ in range(2))
    bias = rng.standard_normal((e, n)).astype(np.float32)
    counts = np.array([[0, c], [c // 2, 1], [c, 5]], np.int32)
    return a, b, b2, bias, counts


@pytest.mark.parametrize("gate", [False, True], ids=["gelu+bias", "silu_gate"])
@pytest.mark.parametrize("strategy,with_counts", [
    ("grouped_einsum", False), ("grouped_einsum", True),
    ("grouped_packed", False), ("grouped_packed_ragged", True)])
def test_grouped_strategy_matches_reference(strategy, with_counts, gate):
    a, b, b2, bias, counts = _grouped_data()
    kw = (dict(b2=b2, epilogue="silu_gate") if gate
          else dict(bias=bias, epilogue="gelu"))
    cnt = counts if with_counts else None

    def conv(x, mod):
        return None if x is None else (
            jnp.asarray(x) if mod == "jax" else torch.from_numpy(x))
    want = rstrat.run_grouped(strategy, jnp.asarray(a), jnp.asarray(b),
                              counts=conv(cnt, "jax"), backend="pallas",
                              interpret=True,
                              **{k_: conv(v, "jax") if k_ != "epilogue" else v
                                 for k_, v in kw.items()})
    got = tstrat.run_grouped(strategy, torch.from_numpy(a),
                             torch.from_numpy(b), counts=conv(cnt, "torch"),
                             **{k_: conv(v, "torch") if k_ != "epilogue"
                                else v for k_, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    if with_counts:
        rows = np.arange(a.shape[1] // 2)[None, None, :] < counts[..., None]
        dead = ~rows.reshape(3, -1)
        assert not got.numpy()[dead].any()


def test_grouped_contract_raw_stack_unfolded_and_folded():
    """``contract`` on [G, E, C, K] with counts [G, E]: the folding kernel
    lowering (ragged) and the unfolded einsum agree."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8, 20)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 20, 12)).astype(np.float32))
    counts = torch.tensor([[8, 0, 3], [5, 8, 1]], dtype=torch.int32)
    spec = ContractionSpec.grouped(3, 16, 20, 12, torch.float32, w=w,
                                   counts=True)
    outs = [tgemm.contract(spec, x, w, counts=counts, strategy=s)
            for s in ("grouped_einsum", "grouped_packed_ragged",
                      "grouped_packed")]   # the last upgrades to ragged
    for out in outs[1:]:
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(), **F32)


# -- planner and dispatch --------------------------------------------------

def test_planner_pins_olmo_serving_shapes():
    """On the card: decode (M=4) streams the strided weight through K7,
    prefill (M=512) packs B per call for K1."""
    assert tplan.choose_strategy(4, 2048, 2048, "bfloat16") == "tiling"
    assert tplan.choose_strategy(4, 2048, 50304, "bfloat16") == "tiling"
    assert tplan.choose_strategy(512, 2048, 8192, "bfloat16") == \
        "tiling_packing_fused"
    assert tplan.choose_strategy(512, 2048, 2048, "bfloat16",
                                 weights_prepacked=True) == \
        "tiling_packing_fused"
    assert tplan.choose_grouped_strategy(8, 160, 6144, 16384, "bfloat16",
                                         counts_known=True) == \
        "grouped_packed_ragged"
    assert tplan.choose_grouped_strategy(8, 160, 6144, 16384,
                                         "bfloat16") == "grouped_packed"
    assert tplan.choose_grouped_strategy(8, 8, 6144, 16384, "bfloat16",
                                         counts_known=True) == \
        "grouped_einsum"


@pytest.mark.parametrize("on_card", [False, True])
def test_auto_dispatch_follows_the_target(on_card):
    dense = {m: tgemm.resolve_strategy(m, 2048, 8192, "bfloat16",
                                       on_card=on_card) for m in (4, 512)}
    grouped = tgemm.resolve_grouped_strategy(8, 160, 6144, 16384, "bfloat16",
                                             counts_known=True,
                                             on_card=on_card)
    if on_card:
        assert dense == {4: "tiling", 512: "tiling_packing_fused"}
        assert grouped == "grouped_packed_ragged"
    else:
        assert dense == {4: "torch_matmul", 512: "torch_matmul"}
        assert grouped == "grouped_einsum"


def test_dispatch_precedence_explicit_env_auto(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_GEMM_STRATEGY", "vsx")
    assert tgemm.resolve_strategy(64, 64, 64, "float32") == "vsx"
    assert tgemm.resolve_strategy(64, 64, 64, "float32", "tiling") == "tiling"
    # a dense override never re-routes a grouped contraction
    assert tgemm.resolve_grouped_strategy(4, 8, 16, 16, "float32") == \
        "grouped_einsum"
    monkeypatch.setenv("REPRO_TORCH_GEMM_STRATEGY", "grouped_packed")
    assert tgemm.resolve_grouped_strategy(4, 8, 16, 16, "float32",
                                          counts_known=True) == \
        "grouped_packed_ragged"
    assert tgemm.resolve_strategy(64, 64, 64, "float32") == "torch_matmul"
    monkeypatch.setenv("REPRO_TORCH_GEMM_STRATEGY", "no_such")
    with pytest.raises(KeyError):
        tgemm.resolve_strategy(64, 64, 64, "float32")


def test_comparison_strategies_are_never_the_auto_pick():
    spec = ContractionSpec.dense(512, 2048, 8192, "bfloat16")
    for name in ("naive", "pluto", "intrinsic", "tiling_packing", "vsx"):
        assert ctr.LOWERINGS[name].cost(spec, True) == ctr.COMPARISON_COST
    assert ctr.LOWERINGS["torch_matmul"].cost(spec, True) == 1.0


# -- the matmul facade ------------------------------------------------------

@pytest.mark.parametrize("strategy", ["auto"] + list(tstrat.STRATEGIES))
def test_matmul_facade_matches_reference(strategy):
    a, b, c, bias = _data(33, 65, 17, seed=6)
    want = ref_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                      alpha=0.5, beta=2.0, bias=jnp.asarray(bias),
                      epilogue=REF_EPILOGUES["tanh"])
    got = tgemm.matmul(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c), alpha=0.5, beta=2.0,
                       bias=torch.from_numpy(bias), epilogue="tanh",
                       strategy=strategy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_c_alpha_beta_are_dense_only_and_packed_weights_refuse_them():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8, 5)).astype(np.float32))
    spec = ContractionSpec.grouped(3, 4, 8, 5, torch.float32, w=w)
    with pytest.raises(ValueError, match="dense-only"):
        tgemm.contract(spec, x, w, alpha=2.0)
    a = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    pw = PackedWeight.pack(w[0])
    with pytest.raises(ValueError, match="no c/alpha/beta"):
        tgemm.matmul(a, pw, torch.zeros(4, 5), beta=1.0)
    np.testing.assert_allclose(tgemm.matmul(a, pw).numpy(),
                               (a @ w[0]).numpy(), **F32)


@pytest.mark.parametrize("dtype,m,want", [
    (torch.bfloat16, 4, "MMA_DECODE"), (torch.float16, 16, "MMA_DECODE"),
    (torch.bfloat16, 17, "MMA_PREFILL"), (torch.float32, 4, "FMA"),
    (torch.int8, 512, "FMA")])
def test_blocked_kernels_pick_tensor_cores_for_half_types_only(dtype, m, want):
    """K6/K7 run bf16/f16 on the tensor cores (the decode variant up to 16
    rows) and f32/int8 on the CUDA-core bodies (f32 in full f32): the
    streaming body up to 16 rows, K split until the card has two blocks an
    SM; the 128 x 128 tiled body at M=512, N=8192."""
    from repro_torch.kernels import gemm_tiled as gt
    assert gt.pick_variant(dtype, m) == getattr(gt, want)
    assert gt.fma_geometry(4, 2048, 2048, item=4, b_kfast=False) == (
        gt.FMA_STREAM, 4, 6, 400)
    assert gt.fma_geometry(512, 2048, 8192, item=4, b_kfast=False)[:2] == (
        gt.FMA_TILED, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", tstrat.STRATEGIES)
def test_cuda_strategies_match_the_f32_product(strategy, dtype):
    """On the card every strategy's kernels against the f32 product
    (relative to max|C|: f32 1e-4, bf16 output 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    a, b, c, bias = (torch.from_numpy(x).cuda() for x in _data(65, 130, 97))
    got = tgemm.matmul(a.to(dtype), b.to(dtype), strategy=strategy)
    want = a.to(dtype).float() @ b.to(dtype).float()
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert got.dtype == dtype and err <= (1e-4 if dtype == torch.float32
                                          else 1e-2)
