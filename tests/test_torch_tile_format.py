"""Port vs reference: packed-B buffers, scale grids, nibble packing and the
dequant / fused-A accumulation oracles. Inputs come from numpy and go to
both packages; packed buffers must be byte-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tile_format as rtf
from repro.kernels import ref as rref
from repro_torch.core import tile_format as ttf
from repro_torch.core.planner import plan_gemm
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# (dtype, scale granularity or None)
FORMATS = [("float32", None), ("bfloat16", None), ("int8", "tile"),
           ("int8", "col"), ("int4", "tile"), ("int4", "col")]
SHAPES = [(37, 50, 16, 32), (64, 64, 32, 16), (100, 33, 32, 32)]  # k, n, bk, bn


def _formats(dtype, gran, layout, bk, bn):
    scale = (dict(scale=rtf.ScaleSpec(granularity=gran)),
             dict(scale=ttf.ScaleSpec(granularity=gran))) if gran else ({}, {})
    return (rtf.TileFormat(bk, bn, layout, dtype, **scale[0]),
            ttf.TileFormat(bk, bn, layout, dtype, **scale[1]))


def _bytes(x) -> bytes:
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
@pytest.mark.parametrize("k,n,bk,bn", SHAPES)
def test_pack_b_byte_identical(dtype, gran, layout, k, n, bk, bn):
    """Tolerance: none — buffers and scales must match byte for byte."""
    w = np.random.default_rng(k * n).standard_normal((k, n)).astype(np.float32)
    rfmt, tfmt = _formats(dtype, gran, layout, bk, bn)
    src_dtype = "bfloat16" if dtype == "bfloat16" else "float32"
    want = rref.pack_b_ref(jnp.asarray(w).astype(src_dtype), rfmt)
    got = tref.pack_b_ref(torch.from_numpy(w).to(getattr(torch, src_dtype)),
                          tfmt)
    if gran:
        (want, want_s), (got, got_s) = want, got
        assert tuple(got_s.shape) == want_s.shape
        assert _bytes(got_s) == _bytes(want_s)
    assert tuple(got.shape) == want.shape == tfmt.packed_shape(k, n)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("dtype,qmax", [("int8", 127), ("int4", 7)])
def test_quantize_rounds_half_to_even_then_clips(dtype, qmax):
    """Exact-.5 inputs: half-to-even rounding, then the clip, as
    ``tile_format.py:288`` (tolerance: exact)."""
    w = np.zeros((16, 16), np.float32)
    w[0, :6] = [qmax, 0.5, 1.5, 2.5, -2.5, -3.5]
    rfmt, tfmt = _formats(dtype, "tile", "row", 16, 16)
    rq, rs = rref.pack_b_ref(jnp.asarray(w), rfmt)
    tq, ts = tref.pack_b_ref(torch.from_numpy(w), tfmt)
    assert _bytes(tq) == _bytes(rq) and _bytes(ts) == _bytes(rs)
    vals = ttf.unpack_nibbles(tq) if dtype == "int4" else tq
    assert vals[0, 0, 0, :6].tolist() == [qmax, 0, 2, 2, -2, -4]
    assert float(ts[0, 0]) == 1.0


def test_int4_unpack_reads_every_byte_like_the_reference():
    """All 256 byte values unpack to the same sign-extended nibbles as the
    reference; -8 reads back (tolerance: exact)."""
    p = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    want = np.asarray(rtf.unpack_nibbles(jnp.asarray(p)))
    got = ttf.unpack_nibbles(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    q = torch.arange(-8, 8, dtype=torch.int8).reshape(1, 16)
    assert torch.equal(ttf.unpack_nibbles(ttf.pack_nibbles(q)), q)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS[2:])
def test_dequant_and_fused_acc_match_reference(dtype, gran, layout):
    """Unpack/dequant round trip and the f32 fused-A accumulator
    (tolerance: rtol=atol=1e-5, f32 sums in different orders)."""
    rng = np.random.default_rng(3)
    k, n, m = 70, 45, 9
    w = rng.standard_normal((k, n)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    rfmt, tfmt = _formats(dtype, gran, layout, 32, 16)
    rq, rs = rref.pack_b_ref(jnp.asarray(w), rfmt)
    tq, ts = tref.pack_b_ref(torch.from_numpy(w), tfmt)
    want = rref.unpack_b_dequant_ref(rq, rs, k, n, layout, fmt=rfmt)
    got = tref.unpack_b_dequant_ref(tq, ts, k, n, layout, fmt=tfmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = rref.fused_packed_acc_ref(jnp.asarray(a), rq, n, layout_b=layout,
                                     b_scales=rs, fmt=rfmt)
    got = tref.fused_packed_acc_ref(torch.from_numpy(a), tq, n,
                                    layout_b=layout, b_scales=ts, fmt=tfmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k,n,b_dtype", [(2048, 2048, None),
                                          (2048, 50304, None),
                                          (8192, 2048, "int4"), (64, 256, None)])
def test_hopper_plan_tiles(k, n, b_dtype):
    """The Hopper planner's tiles: multiples of the matrix unit's 16, bn at
    most the kernel's widest 64-column chunk, so a decode-sized N=2048
    projection has 32 tiles (a TPU-sized bn=512 would give 4)."""
    plan = plan_gemm(1024, k, n, "bfloat16", b_dtype=b_dtype)
    fmt = plan.b_format
    assert plan.bm == 64 and fmt.bn <= 64 and fmt.bn % 16 == 0
    assert fmt.bk % 16 == 0 and fmt.bk <= 128
    assert fmt.is_quantized == (b_dtype is not None)
    if n == 2048:
        assert fmt.grid(k, n)[0] == 32
