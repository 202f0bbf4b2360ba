"""Port vs reference: ``gemm_packed_fused_a``. On the CPU the port's wrapper
runs its plain torch version, held against the reference Pallas kernel in
interpret mode on the same numpy inputs (f32, tolerance rtol=atol=1e-5:
the same f32 products, summed in different orders). The CUDA kernel itself
is held against the plain version on the card (``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tile_format as rtf
from repro.kernels import ref as rref
from repro.kernels.gemm_packed import gemm_packed_fused_a as ref_kernel
from repro_torch.core import tile_format as ttf
from repro_torch.kernels import gemm_packed as gp
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _packed_pair(w, dtype, gran, layout, bk=32, bn=32):
    rs = dict(scale=rtf.ScaleSpec(granularity=gran)) if gran else {}
    ts = dict(scale=ttf.ScaleSpec(granularity=gran)) if gran else {}
    rfmt = rtf.TileFormat(bk, bn, layout, dtype, **rs)
    tfmt = ttf.TileFormat(bk, bn, layout, dtype, **ts)
    r = rref.pack_b_ref(jnp.asarray(w), rfmt)
    t = tref.pack_b_ref(torch.from_numpy(w), tfmt)
    return (rfmt, *(r if gran else (r, None))), (tfmt, *(t if gran else (t, None)))


def _run_both(a, w, n, *, dtype="float32", gran=None, layout="row", bm=16,
              c=None, bias=None, out_dtype=None, **kw):
    (rfmt, rb, rsc), (tfmt, tb, tsc) = _packed_pair(w, dtype, gran, layout)
    want = ref_kernel(jnp.asarray(a), rb, n,
                      None if c is None else jnp.asarray(c), bm=bm,
                      layout_b=layout, b_scales=rsc, b_format=rfmt,
                      bias=None if bias is None else jnp.asarray(bias),
                      out_dtype=out_dtype, interpret=True, **kw)
    got = gp.gemm_packed_fused_a(
        torch.from_numpy(a), tb, n, None if c is None else torch.from_numpy(c),
        bm=bm, layout_b=layout, b_scales=tsc, b_format=tfmt,
        bias=None if bias is None else torch.from_numpy(bias),
        out_dtype=None if out_dtype is None else getattr(torch, out_dtype),
        **kw)
    return got.numpy(), np.asarray(want)


def _data(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", [("float32", None), ("int8", "tile"),
                                        ("int8", "col"), ("int4", "tile"),
                                        ("int4", "col")])
def test_fused_a_matches_reference_kernel(dtype, gran, layout):
    a, w = _data(21, 70, 45)
    got, want = _run_both(a, w, 45, dtype=dtype, gran=gran, layout=layout)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "silu", "tanh"])
def test_fused_a_bias_and_epilogues(epilogue):
    """gelu is the tanh approximation on both sides."""
    a, w = _data(9, 40, 33, seed=1)
    bias = np.random.default_rng(2).standard_normal(33).astype(np.float32)
    got, want = _run_both(a, w, 33, bias=bias, epilogue=epilogue,
                          dtype="int8", gran="tile")
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_a_alpha_beta_c():
    a, w = _data(17, 64, 40, seed=4)
    c = np.random.default_rng(5).standard_normal((17, 40)).astype(np.float32)
    got, want = _run_both(a, w, 40, c=c, alpha=1.5, beta=0.5, bm=32)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_a_int8_activations_accumulate_exactly():
    """int8 A x int8 B: exact integer sums (tolerance: none)."""
    rng = np.random.default_rng(6)
    a = rng.integers(-100, 100, (9, 50)).astype(np.int8)
    w = rng.integers(-100, 100, (50, 20)).astype(np.int8)
    got, want = _run_both(a, w, 20, dtype="int8", out_dtype="int32")
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the plain version and launches nothing."""
    a, w = _data(5, 32, 32)
    fmt = ttf.TileFormat(32, 32)
    bp = tref.pack_b_ref(torch.from_numpy(w), fmt)
    before = gp.gemm_packed_fused_a.launches
    got = gp.gemm_packed_fused_a(torch.from_numpy(a), bp, 32, b_format=fmt)
    want = gp.gemm_packed_fused_a_plain(torch.from_numpy(a), bp, 32,
                                        b_format=fmt)
    assert gp.gemm_packed_fused_a.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["bm", "tile", "scales", "int_scaled"])
def test_launch_checks_refuse_what_the_kernel_does_not_take(bad):
    """The CUDA path's operand checks run before any launch."""
    a = torch.zeros(8, 64)
    fmt = ttf.TileFormat(32, 32 if bad != "tile" else 24)
    bp = tref.pack_b_ref(torch.zeros(64, 48), fmt)
    kw = dict(bm=16, alpha=1.0, beta=0.0, b_scales=None, epilogue="none",
              bias=None, fmt=fmt, stream=None, out=torch.empty(8, 48))
    if bad == "bm":
        kw["bm"] = 8
    if bad == "scales":
        kw["b_scales"] = torch.ones(3)
    if bad == "int_scaled":
        a = torch.zeros(8, 64, dtype=torch.int8)
        qf = ttf.TileFormat(32, 32, dtype="int8", scale=ttf.ScaleSpec())
        bp, s = tref.pack_b_ref(torch.zeros(64, 48), qf)
        kw.update(fmt=qf, b_scales=s)
    with pytest.raises(ValueError):
        gp.launch_args(a, bp, 48, None, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gran", [("bfloat16", None), ("int4", "col")])
def test_cuda_kernel_matches_plain_version(dtype, gran):
    """The CUDA kernel against its plain version on the card (bf16 output:
    rtol 2e-2 for the final bf16 rounding, summation order differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    a, w = _data(37, 300, 200)
    scale = dict(scale=ttf.ScaleSpec(granularity=gran)) if gran else {}
    fmt = ttf.TileFormat(64, 64, dtype=dtype, **scale)
    wt = torch.from_numpy(w).cuda()
    out = tref.pack_b_ref(wt if gran else wt.to(torch.bfloat16), fmt)
    bp, s = out if gran else (out, None)
    at = torch.from_numpy(a).cuda().to(torch.bfloat16)
    got = gp.gemm_packed_fused_a(at, bp, 200, b_scales=s, b_format=fmt,
                                 bm=48, epilogue="gelu")
    want = gp.gemm_packed_fused_a_plain(at, bp, 200, b_scales=s,
                                        b_format=fmt, bm=48, epilogue="gelu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=1e-3)


@pytest.mark.parametrize("a_dtype,b_dtype,m,want", [
    (torch.bfloat16, "bfloat16", 4, gp.MMA_DECODE),
    (torch.bfloat16, "bfloat16", 512, gp.MMA_PREFILL),
    (torch.bfloat16, "int4", 4, gp.MMA_DECODE),
    (torch.float16, "int8", 64, gp.MMA_PREFILL),
    (torch.bfloat16, "float32", 4, gp.FMA),
    (torch.float32, "float32", 512, gp.FMA),
    (torch.int8, "int8", 4, gp.FMA)])
def test_kernel_variant_follows_operand_types_and_rows(a_dtype, b_dtype, m,
                                                       want):
    """Tensor cores only where B widens exactly into the activation type;
    the decode variant up to 16 rows."""
    fmt = ttf.TileFormat(128, 64, dtype=b_dtype)
    assert gp.pick_variant(a_dtype, fmt, m) == want


def test_dispatch_precedence_explicit_env_auto(monkeypatch):
    from repro_torch.core.contraction import ContractionSpec, dispatch
    from repro_torch.core.layered import PackedWeight
    w = PackedWeight.pack(torch.zeros(64, 32))
    packed = ContractionSpec.dense(4, 64, 32, torch.float32, w=w)
    raw = ContractionSpec.dense(4, 64, 32, torch.float32)
    assert dispatch(packed).name == "packed_weight"
    assert dispatch(raw).name == "torch_matmul"
    with pytest.raises(ValueError):
        dispatch(packed, strategy="torch_matmul")
    monkeypatch.setenv("REPRO_TORCH_GEMM_STRATEGY", "torch_matmul")
    assert dispatch(packed).name == "packed_weight"  # env must support it
    monkeypatch.setenv("REPRO_TORCH_GEMM_STRATEGY", "no_such")
    with pytest.raises(KeyError):
        dispatch(raw)
