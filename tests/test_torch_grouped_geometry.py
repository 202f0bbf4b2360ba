"""Launch geometry of K2 (``gemm_grouped_packed_ragged``) and K3
(``gemm_grouped_packed``): the pure-Python route (``grouped_body``), the
TMA alignment test (``grouped_tma_aligned``), the split-K plan and the
argument tuple that ``launch_args`` hands to ``csrc/gemm_grouped_packed.cu``,
and the launch counts by body, pinned on CPU tensors (no launch); and, on a
card (``cuda`` marker), both kernels against their plain versions at the
TMA bodies' edges."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.planner import plan_grouped_gemm
from repro_torch.core.tile_format import ScaleSpec, TileFormat
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels import ref

BF16, F16, F32, I8 = torch.bfloat16, torch.float16, torch.float32, torch.int8
MIXTRAL = dict(e=8, d=6144, f=16384)

# The C entry point's argument positions (gemm_grouped.py _ARGTYPES).
STRIDE_ARGS, BODY_ARG, SPLIT_ARGS = slice(2, 5), 30, slice(31, 34)


def _dt(name):
    return getattr(torch, name)


@pytest.mark.parametrize("a_dtype,b_dtype,gran,c,bk,bn,tma_ok,want", [
    (BF16, "bfloat16", None, 8, 128, 64, True, "tc_stream"),
    (BF16, "bfloat16", None, 1, 64, 64, True, "tc_stream"),
    (BF16, "bfloat16", None, 16, 192, 64, True, "tc_stream"),
    (BF16, "bfloat16", None, 17, 128, 64, True, "wgmma"),
    (BF16, "bfloat16", None, 160, 128, 64, True, "wgmma"),
    (F16, "float16", None, 8, 64, 64, True, "tc_stream"),
    (F16, "float16", None, 160, 128, 64, True, "wgmma"),
    (BF16, "bfloat16", None, 8, 128, 64, False, "mma_sync"),
    (BF16, "bfloat16", None, 160, 128, 64, False, "mma_sync"),
    (BF16, "bfloat16", None, 8, 128, 32, True, "mma_sync"),
    (BF16, "bfloat16", None, 160, 32, 64, True, "mma_sync"),
    (BF16, "bfloat16", None, 8, 32, 64, True, "fma"),
    (BF16, "int8", "tile", 8, 128, 64, True, "tc_stream_q"),
    (BF16, "int4", "col", 160, 128, 64, True, "wgmma_q"),
    (F16, "int8", None, 8, 128, 64, True, "tc_stream_q"),
    (F32, "float32", None, 8, 64, 64, True, "fma"),
    (F32, "int8", "tile", 160, 64, 64, True, "fma"),
    (I8, "int8", None, 8, 64, 64, True, "fma"),
    (I8, "int4", None, 160, 64, 64, True, "fma"),
    (BF16, "float16", None, 8, 128, 64, True, "fma"),
    (BF16, "float32", None, 160, 128, 64, True, "fma")])
def test_grouped_body_follows_the_route_table(a_dtype, b_dtype, gran, c, bk,
                                              bn, tma_ok, want):
    """bf16 / f16 A against aligned unscaled tiles of its type with bn 64 and
    bk % 64 == 0: tc_stream up to 16 rows a segment, wgmma above; against
    int8 / int4 tiles of that geometry tc_stream_q / wgmma_q; every other
    pair keeps the first port's bodies as pick_variant chose them."""
    scale = dict(scale=ScaleSpec(granularity=gran)) if gran else {}
    fmt = TileFormat(bk=bk, bn=bn, dtype=b_dtype, **scale)
    assert gg.grouped_body(a_dtype, fmt, c, scaled=gran is not None,
                           tma_ok=tma_ok) == want


@pytest.mark.parametrize("rows", [1, 8, 160, 512])
@pytest.mark.parametrize("pair", [True, False])
def test_mixtral_planned_tiles_take_the_tma_bodies(rows, pair):
    """The planner's expert tiles for mixtral-8x22b (both contractions, any
    m_hint) are bf16 128 x 64 "row": the TMA bodies' geometry."""
    k, n = (MIXTRAL["d"], MIXTRAL["f"]) if pair else (MIXTRAL["f"],
                                                      MIXTRAL["d"])
    plan = plan_grouped_gemm(MIXTRAL["e"], rows, k, n, "bfloat16",
                             n_b_streams=2 if pair else 1)
    fmt = TileFormat(bk=plan.bk, bn=plan.bn, layout=plan.layout_b,
                     dtype="bfloat16")
    assert (fmt.bk, fmt.bn, fmt.layout) == (128, 64, "row")
    for c, want in ((8, "tc_stream"), (160, "wgmma")):
        assert gg.grouped_body(BF16, fmt, c, scaled=False,
                               tma_ok=True) == want


def _strided(shape, strides, offset=0, dtype=BF16):
    """A view with the given element strides into a zero buffer."""
    span = 1 + offset + sum((d - 1) * s for d, s in zip(shape, strides))
    return torch.zeros(span, dtype=dtype).as_strided(shape, strides, offset)


def _stack(e, k, n, bk=128, offset=0):
    fmt = TileFormat(bk=bk, bn=64, dtype="bfloat16")
    shape = fmt.packed_shape(k, n)
    buf = torch.zeros(e * math.prod(shape) + offset, dtype=BF16)
    return buf[offset:].view(e, *shape), fmt


@pytest.mark.parametrize("a,aligned", [
    (torch.zeros(3, 2, 8, 2048, dtype=BF16), True),
    (torch.zeros(3, 2, 8, 704, dtype=BF16)[..., :700], True),   # lda 704
    (torch.zeros(3, 2, 8, 700, dtype=BF16), False),             # lda * 2 % 16
    (torch.zeros(3, 2, 8, 320, dtype=BF16)[..., 5:305], False),  # base off 16
    (torch.zeros(3, 2, 8, 320, dtype=BF16)[..., 8:308], True),
    (torch.zeros(2, 3, 8, 768, dtype=BF16).permute(1, 0, 2, 3), True),
    (torch.zeros(2, 3, 8, 700, dtype=BF16).permute(1, 0, 2, 3), False),
    (torch.zeros(1, 2, 8, 768, dtype=BF16).expand(3, 2, 8, 768), False),
    # extent-1 dims are never stepped: their strides do not count
    (_strided((3, 1, 8, 704), (5632, 3, 704, 1)), True),
    (_strided((3, 2, 1, 704), (1408, 704, 5, 1)), True),
    (_strided((1, 2, 8, 704), (7, 5632, 704, 1)), True),
    (_strided((3, 2, 1, 700), (1400, 700, 5, 1)), False),
    (torch.zeros(3, 2, 8, 64, dtype=F32), True)])
def test_grouped_tma_alignment(a, aligned):
    """TMA takes 16-byte aligned bases and strides that are positive
    multiples of 16 bytes, in any order (a permuted A), with rows that do
    not overlap; a misaligned A routes to mma_sync."""
    bp, fmt = _stack(a.shape[0], a.shape[3], 200)
    assert gg.grouped_tma_aligned(a, bp) == aligned
    assert gg.grouped_tma_aligned(a, bp, bp) == aligned
    if a.dtype == BF16:
        want = "tc_stream" if aligned else "mma_sync"
        assert gg.grouped_body(BF16, fmt, a.shape[2], scaled=False,
                               tma_ok=gg.grouped_tma_aligned(a, bp)) == want


@pytest.mark.parametrize("which", ["b", "b2"])
def test_grouped_tma_alignment_needs_aligned_stacks(which):
    a = torch.zeros(3, 2, 8, 2048, dtype=BF16)
    good, _ = _stack(3, 2048, 200)
    bad, _ = _stack(3, 2048, 200, offset=1)
    b, b2 = (bad, good) if which == "b" else (good, bad)
    assert not gg.grouped_tma_aligned(a, b, b2)


def test_a_strides_keep_the_strides_that_are_stepped():
    a = torch.zeros(2, 3, 8, 768, dtype=BF16).permute(1, 0, 2, 3)
    assert gg.a_strides(a) == (8 * 768, 3 * 8 * 768, 768)
    one = _strided((3, 1, 1, 700), (1400, 3, 5, 1))
    assert gg.a_strides(one) == (1400, 704, 704)


@pytest.mark.parametrize("e,s,nb,kb", [
    (8, 1, 256, 48),    # mixtral gate/up: 2048 stripes
    (8, 1, 96, 128),    # mixtral down: 768 stripes
    (3, 2, 4, 11),      # a small E*S: K is split
    (2, 1, 4, 6),
    (1, 1, 1, 1),
    (1, 1, 3, 200),
    (8, 2, 32, 16),
    (5, 3, 7, 97)])
def test_grouped_split_covers_kb_once(e, s, nb, kb):
    """tc_stream's split from E*S*Nb stripes and Kb alone: every split
    non-empty, Kb covered once, at least 2 x 132 blocks where Kb allows,
    one split at mixtral's shapes."""
    splits, chunk = gg.tc_stream_split(kb, e * s * nb)
    assert chunk >= 1 and splits * chunk >= kb and (splits - 1) * chunk < kb
    assert e * s * nb * splits >= min(2 * gt.H100_SMS, e * s * nb * kb)
    if e * s * nb >= 2 * gt.H100_SMS:
        assert splits == 1


def _args(a, n, counts=None, *, pair=False, bk=128, fmt=None, bias=None,
          epilogue=None, b_scales=None, out_dtype=None):
    """launch_args on CPU tensors (no launch): (args, keep, body)."""
    e, s, c, k = a.shape
    fmt = fmt or TileFormat(bk=bk, bn=64, dtype=str(a.dtype).split(".")[-1])
    store = _dt(fmt.storage_dtype)
    bp = torch.zeros((e, *fmt.packed_shape(k, n)), dtype=store)
    b2 = torch.zeros_like(bp) if pair else None
    out = torch.empty((e, s, c, n), dtype=out_dtype or a.dtype)
    return gg.launch_args(
        a, bp, n, counts, b2_packed=b2, bm=16, b_scales=b_scales,
        b2_scales=b_scales if pair else None, out=out,
        epilogue=epilogue or ("silu_gate" if pair else "none"), bias=bias,
        fmt=fmt, stream=None)


def test_decode_takes_tc_stream_unsplit_at_mixtral_stripes():
    """E=8 S=2 N=2048 (512 stripes): one split, no workspace, code 4."""
    a = torch.zeros(8, 2, 8, 2048, dtype=BF16)
    args, keep, body = _args(a, 2048, torch.zeros(8, 2, dtype=torch.int32),
                             pair=True)
    assert body == "tc_stream" and args[BODY_ARG] == 4
    assert args[SPLIT_ARGS] == (1, 16, None) and keep[1] is None


@pytest.mark.parametrize("pair", [True, False])
def test_decode_splits_k_on_a_small_grid(pair):
    """E=3 S=2 N=200 K=700 bk 64 (24 stripes): Kb = 11 split in 11, and a
    workspace of [splits, streams, E*S*C, N] f32."""
    a = torch.zeros(3, 2, 8, 704, dtype=BF16)[..., :700]
    args, keep, body = _args(a, 200, torch.zeros(3, 2, dtype=torch.int32),
                             pair=pair, bk=64)
    splits, chunk, ws = args[SPLIT_ARGS]
    assert body == "tc_stream" and (splits, chunk) == (11, 1)
    assert tuple(keep[1].shape) == (11, 2 if pair else 1, 48, 200)
    assert keep[1].dtype == F32 and ws == keep[1].data_ptr()


def test_the_split_does_not_read_the_counts():
    """The host never reads the counts: the same shapes give the same
    arguments whatever the counts hold (the counts pointer apart)."""
    a = torch.zeros(3, 2, 8, 704, dtype=BF16)[..., :700]
    got = []
    for fill in (0, 8, -3):
        args, _, body = _args(a, 200, torch.full((3, 2), fill,
                                                 dtype=torch.int32), bk=64)
        got.append((body, args[BODY_ARG], args[SPLIT_ARGS][:2]))
    assert got[0] == got[1] == got[2] == ("tc_stream", 4, (11, 1))


@pytest.mark.parametrize("c", [17, 160])
def test_prefill_takes_wgmma_unsplit(c):
    a = torch.zeros(8, 1, c, 2048, dtype=BF16)
    args, keep, body = _args(a, 2048, torch.zeros(8, 1, dtype=torch.int32),
                             pair=True)
    assert body == "wgmma" and args[BODY_ARG] == 3
    assert args[SPLIT_ARGS] == (1, 0, None) and keep[1] is None


def test_permuted_a_passes_its_own_strides():
    a = torch.zeros(2, 3, 8, 768, dtype=BF16).permute(1, 0, 2, 3)
    args, _, body = _args(a, 200, torch.zeros(3, 2, dtype=torch.int32))
    assert body == "tc_stream"
    assert args[STRIDE_ARGS] == (8 * 768, 3 * 8 * 768, 768)


@pytest.mark.parametrize("c,code", [(8, 1), (160, 2)])
def test_quantized_tiles_keep_pr12_mma(c, code):
    """int8 tiles with tile scales under a bf16 A that TMA cannot read (its
    base 8 bytes off 16): mma_sync, its decode or prefill tiles by
    pick_variant (an aligned A takes tc_stream_q / wgmma_q)."""
    fmt = TileFormat(bk=128, bn=64, dtype="int8", scale=ScaleSpec())
    a = torch.zeros(2, 1, c, 264, dtype=BF16)[..., 4:260]
    args, _, body = _args(a, 128, None, fmt=fmt,
                          b_scales=torch.ones(2, 2, 2))
    assert body == "mma_sync" and args[BODY_ARG] == code
    assert args[SPLIT_ARGS] == (1, 0, None)


def test_f32_a_keeps_pr12_fma():
    a = torch.zeros(2, 1, 8, 256, dtype=F32)
    args, _, body = _args(a, 128, None, fmt=TileFormat(bk=64, bn=64))
    assert body == "fma" and args[BODY_ARG] == 0


@pytest.mark.parametrize("bad", ["a_3d", "a_col_stride", "segments",
                                 "out_shape", "out_strided", "out_device",
                                 "b2_dtype", "b2_strided"])
def test_launch_args_refuse_what_the_bodies_do_not_take(bad):
    """Each body stores into a contiguous [E, S, C, N] output on A's device
    and reads A with unit column stride, B and B2 as contiguous stacks of
    one format; launch_args raises before any launch."""
    e, s, c, k, n = 2, 1, 8, 128, 64
    a = torch.zeros(e, s, c, k, dtype=BF16)
    fmt = TileFormat(bk=64, bn=64, dtype="bfloat16")
    bp = torch.zeros((e, *fmt.packed_shape(k, n)), dtype=BF16)
    b2 = torch.zeros_like(bp)
    out = torch.empty(e, s, c, n, dtype=BF16)
    if bad == "a_3d":
        a = a[:, 0]
    if bad == "a_col_stride":
        a = torch.zeros(e, s, c, 2 * k, dtype=BF16)[..., ::2]
    if bad == "segments":
        a = torch.zeros(1, 1, c, k, dtype=BF16).expand(1, 65536, c, k)
        bp, b2 = bp[:1], b2[:1]
        out = torch.empty(1, 65536, c, n, dtype=BF16)
    if bad == "out_shape":
        out = torch.empty(e, s, c, n + 1, dtype=BF16)
    if bad == "out_strided":
        out = torch.empty(e, s, c, 2 * n, dtype=BF16)[..., ::2]
    if bad == "out_device":
        out = torch.empty(e, s, c, n, dtype=BF16, device="meta")
    if bad == "b2_dtype":
        b2 = b2.to(F16)
    if bad == "b2_strided":
        b2 = torch.zeros((e, *fmt.packed_shape(k, 2 * n)), dtype=BF16)[:, ::2]
    with pytest.raises(ValueError):
        gg.launch_args(a, bp, n, None, b2_packed=b2, bm=16, b_scales=None,
                       b2_scales=None, out=out, epilogue="silu_gate",
                       bias=None, fmt=fmt, stream=None)


@pytest.mark.parametrize("name", ["gemm_grouped_packed_ragged",
                                  "gemm_grouped_packed"])
@pytest.mark.parametrize("a_dtype,c,fmt,want", [
    (BF16, 8, TileFormat(bk=128, bn=64, dtype="bfloat16"), "tc_stream"),
    (BF16, 40, TileFormat(bk=128, bn=64, dtype="bfloat16"), "wgmma"),
    (BF16, 8, TileFormat(bk=128, bn=32, dtype="bfloat16"), "mma_sync"),
    (F32, 8, TileFormat(bk=64, bn=64), "fma")])
def test_launches_are_counted_by_body(monkeypatch, name, a_dtype, c, fmt,
                                      want):
    """Through a stubbed ``_kernel``: one launch adds one to the wrapper's
    ``launches`` and to ``variants[body]``, the body the C entry point was
    handed; a failed launch raises and counts nothing."""
    fn = getattr(gg, name)
    calls = []

    def kernel(*args):
        calls.append(args)
        return calls[0][BODY_ARG] * 0 if len(calls) == 1 else 1
    monkeypatch.setattr(gg, "_kernel", lambda: kernel)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "variants", dict.fromkeys(gg.GROUPED_BODIES, 0))
    e, k, n = 2, 256, 128
    a = torch.zeros(e, 1, c, k, dtype=a_dtype)
    bp = torch.zeros((e, *fmt.packed_shape(k, n)),
                     dtype=_dt(fmt.storage_dtype))
    counts = (torch.zeros(e, 1, dtype=torch.int32)
              if name == "gemm_grouped_packed_ragged" else None)
    kw = dict(out_dtype=a_dtype, stream=None, b2_packed=None, bm=16,
              b_scales=None, b2_scales=None, epilogue="none", bias=None,
              fmt=fmt)
    out = gg._launch(fn, a, bp, n, counts, **kw)
    assert tuple(out.shape) == (e, 1, c, n)
    assert fn.launches == 1 and fn.variants[want] == 1
    assert sum(fn.variants.values()) == 1
    assert calls[0][BODY_ARG] == (gg._BODY_CODE.get(want) if want != "mma_sync"
                                  else gg.pick_variant(a_dtype, fmt, c))
    with pytest.raises(RuntimeError, match=want):
        gg._launch(fn, a, bp, n, counts, **kw)
    assert fn.launches == 1 and sum(fn.variants.values()) == 1


def test_both_wrappers_count_every_body():
    for fn in (gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed):
        assert set(fn.variants) == set(gg.GROUPED_BODIES)


# -- on the card: K2 / K3 against their plain versions at the edges ---------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _a_view(rng, e, s, c, k, dtype=BF16):
    """[E, S, C, K] view of a buffer whose columns past K hold NaN (row
    stride a multiple of 8)."""
    buf = torch.full((e, s, c, -(-k // 8) * 8 + 8), float("nan"))
    buf[..., :k] = torch.from_numpy(rng.standard_normal((e, s, c, k),
                                                        np.float32))
    return buf.cuda().to(dtype)[..., :k]


def _cuda_stack(rng, e, k, n, bk, layout, dtype=BF16):
    w = torch.from_numpy(rng.standard_normal((e, k, n), np.float32) * 0.05)
    fmt = TileFormat(bk=bk, bn=64, layout=layout,
                     dtype=str(dtype).split(".")[-1])
    return ref.pack_b_grouped_ref(w.cuda().to(dtype), fmt), fmt


def _check(fn, plain, body, args, counts=None, **kw):
    """The wrapper against its plain version (bf16 / f16 output 2e-2 /
    1e-3: f32 sums in other orders, one rounding) on the body it must
    take; rows at or past the counts exactly 0."""
    before = dict(fn.variants)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert [v for v, n in fn.variants.items() if n != before[v]] == [body]
    want = plain(*args, **kw)
    err = (got.float() - want.float()).abs()
    assert bool(torch.all(err <= 1e-3 + 2e-2 * want.float().abs())), \
        float(err.max())
    if counts is not None:
        c = args[0].shape[2]
        assert not got[~ref.ragged_row_mask(c, counts.clamp(0, c))].any()


def _counts(c):
    return torch.tensor([[0, c], [c // 2, 1], [c + 7, -2]],
                        dtype=torch.int32, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 16, 17, 160, 300])
@pytest.mark.parametrize("bk,layout", [(64, "row"), (128, "col"),
                                       (128, "row")])
@pytest.mark.parametrize("dtype", [BF16, F16])
def test_cuda_k2_pair_at_edge_shapes(c, bk, layout, dtype):
    """The pair with B != B2 and bias, K = 700 (the last box partly or
    wholly padding), N = 200, NaN past K in A, counts 0 / partial / C /
    > C / negative over S = 2 (split K at C <= 16)."""
    _cuda()
    rng = np.random.default_rng(c * bk)
    e, s, k, n = 3, 2, 700, 200
    bp, fmt = _cuda_stack(rng, e, k, n, bk, layout, dtype)
    b2p, _ = _cuda_stack(rng, e, k, n, bk, layout, dtype)
    counts = _counts(c)
    bias = torch.from_numpy(rng.standard_normal((e, n), np.float32)).cuda()
    _check(gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed_ragged_plain,
           "tc_stream" if c <= 16 else "wgmma",
           (_a_view(rng, e, s, c, k, dtype), bp, n, counts), counts,
           b2_packed=b2p, b_format=fmt, epilogue="silu_gate", bias=bias)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 17, 160])
def test_cuda_k3_at_edge_shapes(c):
    _cuda()
    rng = np.random.default_rng(c)
    bp, fmt = _cuda_stack(rng, 3, 700, 200, 64, "row")
    b2p, _ = _cuda_stack(rng, 3, 700, 200, 64, "row")
    _check(gg.gemm_grouped_packed, gg.gemm_grouped_packed_plain,
           "tc_stream" if c <= 16 else "wgmma",
           (_a_view(rng, 3, 1, c, 700)[:, 0], bp, 200), b2_packed=b2p,
           b_format=fmt, epilogue="silu_gate")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 160])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "silu", "tanh"])
def test_cuda_k2_every_epilogue_once(c, epilogue):
    """Each epilogue with bias after the split sum (C = 8, K split) and on
    wgmma (C = 160); N = 136 leaves an odd Nb."""
    _cuda()
    rng = np.random.default_rng(c)
    bp, fmt = _cuda_stack(rng, 3, 700, 136, 128, "row")
    bias = torch.from_numpy(rng.standard_normal((3, 136), np.float32)).cuda()
    _check(gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed_ragged_plain,
           "tc_stream" if c <= 16 else "wgmma",
           (_a_view(rng, 3, 2, c, 700), bp, 136, _counts(c)), _counts(c),
           b_format=fmt, epilogue=epilogue, bias=bias)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 40])
def test_cuda_k2_permuted_a(c):
    """S = 2 with A stored [S, E, C, K] (sa_e < sa_s): the 4-D map keeps
    A's own strides."""
    _cuda()
    rng = np.random.default_rng(c)
    a = torch.from_numpy(rng.standard_normal((2, 3, c, 768), np.float32))
    a = a.cuda().to(BF16).permute(1, 0, 2, 3)
    bp, fmt = _cuda_stack(rng, 3, 768, 200, 128, "row")
    b2p, _ = _cuda_stack(rng, 3, 768, 200, 128, "row")
    _check(gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed_ragged_plain,
           "tc_stream" if c <= 16 else "wgmma", (a, bp, 200, _counts(c)),
           _counts(c), b2_packed=b2p, b_format=fmt, epilogue="silu_gate")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 40])
def test_cuda_k2_misaligned_a_takes_mma_sync(c):
    _cuda()
    rng = np.random.default_rng(c)
    a = torch.from_numpy(rng.standard_normal((3, 2, c, 320), np.float32))
    a = a.cuda().to(BF16)[..., 5:305]
    bp, fmt = _cuda_stack(rng, 3, 300, 200, 128, "row")
    b2p, _ = _cuda_stack(rng, 3, 300, 200, 128, "row")
    _check(gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed_ragged_plain,
           "mma_sync", (a, bp, 200, _counts(c)), _counts(c), b2_packed=b2p,
           b_format=fmt, epilogue="silu_gate")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 160])
def test_cuda_k2_dead_segments_store_zeros(c):
    """Every segment dead (no load anywhere), and an unsplit decode grid
    (E = 8, S = 2, N = 2048) with dead segments: zeros, never the
    allocator's garbage."""
    _cuda()
    rng = np.random.default_rng(c)
    bp, fmt = _cuda_stack(rng, 8, 2048, 2048, 128, "row")
    b2p, _ = _cuda_stack(rng, 8, 2048, 2048, 128, "row")
    for counts in (torch.zeros(8, 2, dtype=torch.int32, device="cuda"),
                   torch.tensor([[2, 0], [c, 1], [0, 0], [3, 5]] * 2,
                                dtype=torch.int32, device="cuda")):
        torch.full((8 * 2 * c * 2048,), float("nan"), dtype=BF16,
                   device="cuda")  # freed: the output's block holds NaN
        _check(gg.gemm_grouped_packed_ragged,
               gg.gemm_grouped_packed_ragged_plain,
               "tc_stream" if c <= 16 else "wgmma",
               (_a_view(rng, 8, 2, c, 2048), bp, 2048, counts), counts,
               b2_packed=b2p, b_format=fmt, epilogue="silu_gate")
