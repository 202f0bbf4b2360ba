"""Port vs reference: the per-call packers (K5). On the CPU the port's
``pack_a`` / ``pack_b`` / ``pack_b_grouped`` run their plain torch versions,
held BYTE-identical against the reference Pallas packers in interpret mode
on the same numpy inputs: zero-filled remainder tiles, "col" tiles
transposed, int4 element 2i in the low nibble, and the scale grids
([Nb, Kb], [Nb]; grouped [E, Nb, Kb], [E, Nb]). The CUDA wrapper's own
split (quantize in torch, then one tile-major copy of the int8 values) is
held against the same buffers; the kernel itself is checked on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tile_format as rtf
from repro.kernels import pack as rpack
from repro.kernels import ref as rref
from repro_torch.core import tile_format as ttf
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# (element dtype, scale granularity): raw float / int copies, then the
# quantized formats (quantized from f32 weights).
FORMATS = [("float32", None), ("bfloat16", None), ("int8", None),
           ("int8", "tile"), ("int8", "col"), ("int4", "tile"),
           ("int4", "col")]


def _bytes(x) -> np.ndarray:
    """A tensor / array as its raw bytes."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


def _inputs(shape, dtype, seed=0):
    """The same values as a jnp array and a torch tensor."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        x = rng.integers(-128, 128, shape).astype(np.int8)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _formats(dtype, gran, layout, bk, bn):
    if gran is None:
        return (rtf.TileFormat(bk, bn, layout, dtype),
                ttf.TileFormat(bk, bn, layout, dtype))
    return (rtf.TileFormat(bk, bn, layout, dtype,
                           rtf.ScaleSpec(granularity=gran)),
            ttf.TileFormat(bk, bn, layout, dtype,
                           ttf.ScaleSpec(granularity=gran)))


def _assert_same(got, want, quantized):
    if quantized:
        (gp, gs), (wp, ws) = got, want
        np.testing.assert_array_equal(_bytes(gs), _bytes(ws))
    else:
        gp, wp = got, want
    assert tuple(gp.shape) == tuple(np.asarray(wp).shape)
    np.testing.assert_array_equal(_bytes(gp), _bytes(wp))


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pack_a_byte_identical(dtype, layout):
    ja, ta = _inputs((37, 70), dtype)
    want = rpack.pack_a(ja, 16, 32, layout=layout, interpret=True)
    got = tpack.pack_a(ta, 16, 32, layout=layout)
    _assert_same(got, want, False)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
def test_pack_b_byte_identical(dtype, gran, layout):
    rfmt, tfmt = _formats(dtype, gran, layout, 32, 16)
    jb, tb = _inputs((70, 45), "float32" if gran else dtype, seed=1)
    want = rpack.pack_b(jb, rfmt, interpret=True)
    got = tpack.pack_b(tb, tfmt)
    _assert_same(got, want, gran is not None)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
def test_pack_b_grouped_byte_identical(dtype, gran, layout):
    rfmt, tfmt = _formats(dtype, gran, layout, 16, 32)
    jb, tb = _inputs((3, 40, 50), "float32" if gran else dtype, seed=2)
    want = rpack.pack_b_grouped(jb, rfmt, interpret=True)
    got = tpack.pack_b_grouped(tb, tfmt)
    _assert_same(got, want, gran is not None)


@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", [f for f in FORMATS if f[1]])
def test_quantize_then_copy_is_the_quantized_pack(dtype, gran, layout):
    """What the CUDA wrapper does — quantize in torch into B's natural
    layout, then copy the int8 values tile-major (nibble-packing int4) —
    gives the quantized packer's buffer and scales, for a matrix and for a
    stack."""
    _, tfmt = _formats(dtype, gran, layout, 32, 16)
    raw = ttf.TileFormat(32, 16, layout, dtype)
    for shape in ((70, 45), (2, 70, 45)):
        _, tb = _inputs(shape, "float32", seed=3)
        q_nat, scales = tpack.quantize_natural(tb, tfmt)
        assert q_nat.dtype == torch.int8 and q_nat.shape[-2:] == (96, 48)
        want_packed, want_scales = tref.pack_b_ref(tb, tfmt)
        np.testing.assert_array_equal(_bytes(tref.pack_b_ref(q_nat, raw)),
                                      _bytes(want_packed))
        np.testing.assert_array_equal(_bytes(scales), _bytes(want_scales))


def test_pack_b_reads_a_transposed_view_as_its_copy():
    """A strided source (the raw LM head is ``table.t()``) packs as its
    contiguous copy does."""
    _, t = _inputs((45, 70), "float32", seed=4)
    fmt = ttf.TileFormat(32, 16)
    np.testing.assert_array_equal(
        _bytes(tpack.pack_b(t.t(), fmt)),
        _bytes(tpack.pack_b(t.t().contiguous(), fmt)))


def test_cpu_packing_counts_no_launch_and_other_devices_raise():
    for fn in (tpack.pack_a, tpack.pack_b, tpack.pack_b_grouped):
        fn.launches = 0
    _, t = _inputs((2, 20, 24), "float32", seed=5)
    tpack.pack_a(t[0], 16, 16)
    tpack.pack_b(t[0], 16, 16)
    tpack.pack_b_grouped(t, 16, 16)
    assert (tpack.pack_a.launches, tpack.pack_b.launches,
            tpack.pack_b_grouped.launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpack.pack_b(t[0].to("meta"), 16, 16)


@pytest.mark.parametrize("quantize", [None, "int8", "int4:col"])
@pytest.mark.parametrize("grouped", [False, True])
def test_load_time_packing_goes_through_the_pack_wrappers(monkeypatch,
                                                          quantize, grouped):
    """``PackedWeight.pack`` / ``GroupedPackedWeight.pack`` pack with K5's
    wrappers (the kernel on the card, the plain version here), once per
    weight, into the plain packer's bytes."""
    from repro_torch.core import layered
    calls = []

    def counted(fn):
        def wrapper(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapper
    monkeypatch.setattr(layered, "pack_b", counted(tpack.pack_b))
    monkeypatch.setattr(layered, "pack_b_grouped",
                        counted(tpack.pack_b_grouped))
    shape = (3, 150, 100) if grouped else (150, 100)
    _, w = _inputs(shape, "float32", seed=6)
    cls = layered.GroupedPackedWeight if grouped else layered.PackedWeight
    pw = cls.pack(w, quantize=quantize)
    assert calls == ["pack_b_grouped" if grouped else "pack_b"]
    plain = (tref.pack_b_grouped_ref if grouped else tref.pack_b_ref)(
        w, pw.plan.b_format)
    want, want_scales = plain if quantize else (plain, None)
    np.testing.assert_array_equal(_bytes(pw.packed), _bytes(want))
    assert (pw.scales is None) == (want_scales is None)
    if want_scales is not None:
        np.testing.assert_array_equal(_bytes(pw.scales), _bytes(want_scales))


@pytest.mark.parametrize("layout_a,layout_b", [("row", "row"), ("col", "col"),
                                               ("row", "col")])
def test_gemm_oracles_match_reference(layout_a, layout_b):
    """The port's pack/unpack and GEMM oracles against the reference's: A
    round-trips through its packed form, ``packed_matmul_ref`` contracts
    the two packed stacks and ``gemm_ref`` is alpha * A @ B + beta * C."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((21, 50)).astype(np.float32)
    b = rng.standard_normal((50, 30)).astype(np.float32)
    c = rng.standard_normal((21, 30)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ap = tref.pack_a_ref(ta, 16, 32, layout_a)
    np.testing.assert_array_equal(tref.unpack_a_ref(ap, 21, 50, layout_a).numpy(), a)
    bp = tref.pack_b_ref(tb, 32, 16, layout_b)
    want = rref.packed_matmul_ref(rref.pack_a_ref(jnp.asarray(a), 16, 32, layout_a),
                                  rref.pack_b_ref(jnp.asarray(b), 32, 16, layout_b),
                                  21, 30, layout_a, layout_b)
    np.testing.assert_allclose(
        tref.packed_matmul_ref(ap, bp, 21, 30, layout_a, layout_b).numpy(),
        np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tref.gemm_ref(ta, tb, torch.from_numpy(c), 1.5, 0.5).numpy(),
        np.asarray(rref.gemm_ref(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(c), 1.5, 0.5)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("dtype,gran", FORMATS)
def test_cuda_packers_byte_equal_to_plain(dtype, gran, layout):
    """On the card the pack kernel against the plain packers, byte for
    byte, for a matrix and a stack."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    _, tfmt = _formats(dtype, gran, layout, 32, 16)
    for shape in ((70, 45), (3, 70, 45)):
        _, tb = _inputs(shape, "float32" if gran else dtype, seed=7)
        tb = tb.cuda()
        fn, plain = ((tpack.pack_b, tpack.pack_b_plain) if len(shape) == 2
                     else (tpack.pack_b_grouped, tpack.pack_b_grouped_plain))
        got, want = fn(tb, tfmt), plain(tb, tfmt)
        torch.cuda.synchronize()
        _assert_same(tuple(x.cpu() for x in got) if gran else got.cpu(),
                     tuple(x.cpu() for x in want) if gran else want.cpu(),
                     gran is not None)
