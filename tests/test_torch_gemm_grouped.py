"""Port vs reference: the grouped kernels K2 ``gemm_grouped_packed_ragged``
and K3 ``gemm_grouped_packed``, the grouped packer and GroupedPackedWeight.

On the CPU the port's wrappers run their plain torch versions, held against
the reference Pallas kernels in interpret mode (as ``tests/test_ragged_gemm.py``
runs them) on the same numpy inputs: f32, tolerance rtol=atol=1e-5 (the same
f32 products, summed in different orders; col scales multiply the
accumulator in the kernel and the weight in the plain version). Grouped
pack buffers and scale grids must be byte-identical. The CUDA kernel itself
is held against the plain version on the card (``tests/test_torch_moe.py``,
``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GroupedPackedWeight as RefGroupedPackedWeight
from repro.core import tile_format as rtf
from repro.kernels import ref as rref
from repro.kernels.gemm_grouped import gemm_grouped_packed as ref_k3
from repro.kernels.gemm_grouped import gemm_grouped_packed_ragged as ref_k2
from repro_torch.core import tile_format as ttf
from repro_torch.core.layered import GroupedPackedWeight
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# The gate pair multiplies one accumulator's rounding error (~1e-6 of terms
# of magnitude ~1 here) by the other accumulator (up to ~30): atol 1e-4.
TOL_PAIR = dict(rtol=1e-5, atol=1e-4)
FORMATS = [("float32", None), ("int8", "tile"), ("int8", "col"),
           ("int4", "tile"), ("int4", "col")]


def _fmts(dtype, gran, layout, bk=32, bn=32):
    rs = dict(scale=rtf.ScaleSpec(granularity=gran)) if gran else {}
    ts = dict(scale=ttf.ScaleSpec(granularity=gran)) if gran else {}
    return (rtf.TileFormat(bk, bn, layout, dtype, **rs),
            ttf.TileFormat(bk, bn, layout, dtype, **ts))


def _pack_both(w, rfmt, tfmt):
    """((ref packed, ref scales), (port packed, port scales))."""
    r = rref.pack_b_grouped_ref(jnp.asarray(w), rfmt)
    t = tref.pack_b_grouped_ref(torch.from_numpy(w), tfmt)
    if rfmt.is_quantized:
        return r, t
    return (r, None), (t, None)


def _operands(seed, e, m, k, n, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, *lead, m, k)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32),
            rng.standard_normal((e, k, n)).astype(np.float32),
            rng.standard_normal((e, n)).astype(np.float32))


def _run_both(kind, a, w, n, *, counts=None, dtype="float32", gran=None,
              layout="row", w2=None, bias=None, epilogue="none"):
    """The reference kernel (interpret) and the port's wrapper (CPU: plain)
    on the same operands; returns (port, reference) as numpy."""
    rfmt, tfmt = _fmts(dtype, gran, layout)
    (rb, rs), (tb, ts) = _pack_both(w, rfmt, tfmt)
    (rb2, rs2), (tb2, ts2) = (_pack_both(w2, rfmt, tfmt) if w2 is not None
                              else ((None, None), (None, None)))
    rkw = dict(b2_packed=rb2, bm=16, layout_b=layout, b_scales=rs,
               b2_scales=rs2, epilogue=epilogue, b_format=rfmt,
               bias=None if bias is None else jnp.asarray(bias),
               interpret=True)
    tkw = dict(b2_packed=tb2, bm=16, layout_b=layout, b_scales=ts,
               b2_scales=ts2, epilogue=epilogue, b_format=tfmt,
               bias=None if bias is None else torch.from_numpy(bias))
    if kind == "ragged":
        want = ref_k2(jnp.asarray(a), rb, n, jnp.asarray(counts, jnp.int32),
                      **rkw)
        got = gg.gemm_grouped_packed_ragged(
            torch.from_numpy(a), tb, n,
            torch.from_numpy(np.asarray(counts, np.int32)), **tkw)
    else:
        want = ref_k3(jnp.asarray(a), rb, n, **rkw)
        got = gg.gemm_grouped_packed(torch.from_numpy(a), tb, n, **tkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
def test_grouped_pack_buffers_are_byte_identical(dtype, gran, layout):
    """Odd K and N (ragged tile edges, zero-filled), three experts."""
    w = np.random.default_rng(0).standard_normal((3, 70, 45)).astype(np.float32)
    rfmt, tfmt = _fmts(dtype, gran, layout)
    (rb, rs), (tb, ts) = _pack_both(w, rfmt, tfmt)
    assert tb.dtype == getattr(torch, tfmt.storage_dtype)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    if gran:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    back = tref.unpack_b_grouped_ref(tb, 70, 45, layout, scales=ts, fmt=tfmt)
    want = rref.unpack_b_grouped_ref(rb, 70, 45, layout, scales=rs, fmt=rfmt)
    np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
def test_k3_matches_reference_kernel(dtype, gran, layout):
    a, w, _, _ = _operands(1, 3, 21, 70, 45)
    got, want = _run_both("grouped", a, w, 45, dtype=dtype, gran=gran,
                          layout=layout)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
def test_k2_matches_reference_kernel(dtype, gran, layout):
    """Counts of 0, partial and C (= 21) over three experts, S = 1."""
    a, w, _, _ = _operands(2, 3, 21, 70, 45, lead=(1,))
    counts = np.array([[0], [13], [21]])
    got, want = _run_both("ragged", a, w, 45, counts=counts, dtype=dtype,
                          gran=gran, layout=layout)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0].any() and not got[1, 0, 13:].any()


@pytest.mark.parametrize("kind", ["grouped", "ragged"])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "silu", "tanh"])
def test_bias_and_epilogues(kind, epilogue):
    """gelu is the tanh approximation on both sides; int8 tile-scaled B."""
    lead = (2,) if kind == "ragged" else ()
    a, w, _, bias = _operands(3, 2, 18, 40, 33, lead=lead)
    counts = np.array([[18, 5], [0, 11]])
    got, want = _run_both(kind, a, w, 33, counts=counts, bias=bias,
                          epilogue=epilogue, dtype="int8", gran="tile")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["grouped", "ragged"])
@pytest.mark.parametrize("dtype,gran,layout", [("float32", None, "row"),
                                               ("int8", "tile", "col"),
                                               ("int4", "col", "row")])
def test_silu_gate_pair(kind, dtype, gran, layout):
    """silu(A @ Bg) * (A @ Bu) with both stacks quantized alike."""
    lead = (1,) if kind == "ragged" else ()
    a, w, w2, _ = _operands(4, 3, 20, 48, 40, lead=lead)
    counts = np.array([[20], [7], [0]])
    got, want = _run_both(kind, a, w, 40, counts=counts, w2=w2,
                          epilogue="silu_gate", dtype=dtype, gran=gran,
                          layout=layout)
    np.testing.assert_allclose(got, want, **TOL_PAIR)


def test_k2_several_segments_and_out_of_range_counts():
    """S = 3 segments per expert; counts below 0 and above C are clamped
    to [0, C] on both sides."""
    a, w, _, bias = _operands(5, 2, 17, 40, 24, lead=(3,))
    counts = np.array([[-3, 17, 9], [40, 0, 1]])
    got, want = _run_both("ragged", a, w, 24, counts=counts, bias=bias,
                          epilogue="silu")
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[0, 0].any() and not got[1, 1].any()
    assert got[1, 0].any(axis=-1).all()  # 40 clamps to C: every row live


def test_cpu_tensors_take_the_plain_version():
    """On the CPU both wrappers are their plain versions and launch
    nothing."""
    a, w, w2, _ = _operands(6, 2, 8, 32, 32, lead=(1,))
    fmt = ttf.TileFormat(32, 32)
    bp = tref.pack_b_grouped_ref(torch.from_numpy(w), fmt)
    b2p = tref.pack_b_grouped_ref(torch.from_numpy(w2), fmt)
    counts = torch.tensor([[3], [8]], dtype=torch.int32)
    at = torch.from_numpy(a)
    before = (gg.gemm_grouped_packed_ragged.launches,
              gg.gemm_grouped_packed.launches)
    got = gg.gemm_grouped_packed_ragged(at, bp, 32, counts, b2_packed=b2p,
                                        epilogue="silu_gate", b_format=fmt)
    want = gg.gemm_grouped_packed_ragged_plain(
        at, bp, 32, counts, b2_packed=b2p, epilogue="silu_gate", b_format=fmt)
    assert torch.equal(got, want)
    assert torch.equal(gg.gemm_grouped_packed(at[:, 0], bp, 32, b_format=fmt),
                       gg.gemm_grouped_packed_plain(at[:, 0], bp, 32,
                                                    b_format=fmt))
    assert (gg.gemm_grouped_packed_ragged.launches,
            gg.gemm_grouped_packed.launches) == before


@pytest.mark.parametrize("bad", ["counts_dtype", "counts_shape", "pair_shape",
                                 "bias", "bm", "scales", "tile", "a_dtype"])
def test_launch_checks_refuse_what_the_kernel_does_not_take(bad):
    """The CUDA path's operand checks run before any launch."""
    e, s, c, k, n = 2, 1, 8, 64, 48
    a = torch.zeros(e, s, c, k)
    fmt = ttf.TileFormat(32, 32 if bad != "tile" else 24)
    bp = tref.pack_b_grouped_ref(torch.zeros(e, k, n), fmt)
    kw = dict(b2_packed=None, bm=16, b_scales=None, b2_scales=None,
              out=torch.empty(e, s, c, n), epilogue="none", bias=None,
              fmt=fmt, stream=None)
    counts = torch.zeros(e, s, dtype=torch.int32)
    if bad == "counts_dtype":
        counts = counts.long()
    if bad == "counts_shape":
        counts = torch.zeros(e, 2, dtype=torch.int32)
    if bad == "pair_shape":
        kw.update(b2_packed=tref.pack_b_grouped_ref(torch.zeros(e, k, 32), fmt),
                  epilogue="silu_gate")
    if bad == "bias":
        kw["bias"] = torch.zeros(n)
    if bad == "bm":
        kw["bm"] = 8
    if bad == "scales":
        qf = ttf.TileFormat(32, 32, dtype="int8", scale=ttf.ScaleSpec())
        bp, sc = tref.pack_b_grouped_ref(torch.zeros(e, k, n), qf)
        kw.update(fmt=qf, b_scales=sc[0])
    if bad == "a_dtype":
        a = a.to(torch.float64)
    with pytest.raises(ValueError):
        gg.launch_args(a, bp, n, counts, **kw)


@pytest.mark.parametrize("quantize", [None, "int8", "int4:col"])
@pytest.mark.parametrize("ragged", [False, True])
def test_grouped_packed_weight_matches_reference(quantize, ragged):
    """``GroupedPackedWeight`` matmul (bias + gelu) and silu_gate, with and
    without counts, against the reference's on its jnp path: the same
    contraction from two independently packed stacks."""
    e, s, c, k, n = 3, 2, 12, 40, 24
    a, w, w2, bias = _operands(7, e, c, k, n, lead=(s,))
    counts = np.array([[12, 0], [5, 9], [0, 1]], np.int32)
    kw = dict(quantize=quantize)
    rg = RefGroupedPackedWeight.pack(jnp.asarray(w), backend="jnp",
                                     n_b_streams=2, **kw)
    ru = RefGroupedPackedWeight.pack(jnp.asarray(w2), backend="jnp",
                                     n_b_streams=2, **kw)
    tg = GroupedPackedWeight.pack(torch.from_numpy(w), n_b_streams=2, **kw)
    tu = GroupedPackedWeight.pack(torch.from_numpy(w2), n_b_streams=2, **kw)
    if ragged:
        ra, ta = jnp.asarray(a), torch.from_numpy(a)
        rc, tc = jnp.asarray(counts), torch.from_numpy(counts)
    else:
        ra, ta = jnp.asarray(a.reshape(e, s * c, k)), torch.from_numpy(
            a.reshape(e, s * c, k))
        rc = tc = None
    want = rg.matmul(ra, counts=rc, bias=jnp.asarray(bias), epilogue="gelu",
                     backend="jnp")
    got = tg.matmul(ta, counts=tc, bias=torch.from_numpy(bias),
                    epilogue="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = rg.silu_gate(ru, ra, counts=rc, backend="jnp")
    got = tg.silu_gate(tu, ta, counts=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_PAIR)


@pytest.mark.parametrize("gate", [False, True])
def test_ragged_oracle_matches_reference(gate):
    """``grouped_ragged_ref`` (natural [E, K, N] weights) with bias and an
    epilogue, or the silu-gate partner, against the reference oracle."""
    a, w, w2, bias = _operands(8, 2, 9, 24, 16, lead=(2,))
    counts = np.array([[9, 0], [4, 2]], np.int32)
    kw = dict(b2=w2) if gate else dict(bias=bias)
    want = rref.grouped_ragged_ref(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(counts),
        **{k: jnp.asarray(v) for k, v in kw.items()},
        epilogue_fn=None if gate else jnp.tanh)
    got = tref.grouped_ragged_ref(
        torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(counts),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
        epilogue_fn=None if gate else torch.tanh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_PAIR)
    np.testing.assert_array_equal(
        tref.ragged_row_mask(9, torch.from_numpy(counts)).numpy(),
        np.asarray(rref.ragged_row_mask(9, jnp.asarray(counts))))
