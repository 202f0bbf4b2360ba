"""Launch geometry of K6 (``gemm_packed``) and K8 (``matmul_vsx_like``,
``matmul_vsx_like_packed``): the pure-Python choice of body, block tile
and split-K factor that the wrappers hand to the CUDA sources, pinned at
olmo-1b's shapes and the paper's sweep; and, on a card (``cuda`` marker),
both kernels against their plain versions at the shapes that reach each
body's edges."""
import numpy as np
import pytest
import torch

from repro_torch.core.planner import plan_gemm
from repro_torch.kernels import gemm_packed as gp
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels import gemm_vsx_like as gv
from repro_torch.kernels import pack as pk

OLMO = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304)]
SWEEP = [16, 32, 64, 128, 256, 512, 1024, 2048, 4096]


def _blocks(m, n, item, b_kfast, geometry):
    body, tile, splits, _ = geometry
    if body == gt.FMA_STREAM:
        tiles = -(-n // gt.stream_bn(item, b_kfast))
    else:
        tiles = -(-m // (64 * tile)) * -(-n // (64 * tile))
    return tiles * splits


def _covers(k, splits, kchunk, align):
    return (kchunk % align == 0 and splits * kchunk >= k
            and (splits - 1) * kchunk < k)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 512])
@pytest.mark.parametrize("k,n", OLMO + [(300, 200)])
@pytest.mark.parametrize("item,b_kfast,align", [
    (2, False, 16), (2, True, 16), (2, False, 128), (4, True, 64),
    (1, False, 16)])
def test_fma_splits_cover_k_exactly_once(m, k, n, item, b_kfast, align):
    """Every split of the CUDA-core plan is non-empty, the splits cover K
    once, and each starts on a multiple of the packed bk (``align``)."""
    body, tile, splits, kchunk = gt.fma_geometry(
        m, k, n, item=item, b_kfast=b_kfast, align=align)
    assert body == (gt.FMA_STREAM if m <= 16 else gt.FMA_TILED)
    assert m <= tile if body == gt.FMA_STREAM else tile in (1, 2)
    assert _covers(k, splits, kchunk, align) and kchunk % 16 == 0


@pytest.mark.parametrize("k,n", OLMO)
@pytest.mark.parametrize("b", ["row-major", "table.t()", "packed row",
                               "packed col"])
def test_k8_decode_grid_fills_the_card_twice(k, n, b):
    """At M=4 (olmo-1b decode) K8's grid holds at least 2 x 132 blocks."""
    b_kfast = b in ("table.t()", "packed col")
    align = 128 if b.startswith("packed") else 16
    geo = gt.fma_geometry(4, k, n, item=2, b_kfast=b_kfast, align=align)
    assert geo[0] == gt.FMA_STREAM and geo[1] == 4
    assert _blocks(4, n, 2, b_kfast, geo) >= 2 * gt.H100_SMS


@pytest.mark.parametrize("k,n", OLMO)
def test_k6_decode_split_covers_kb_and_fills_the_card(k, n):
    """V_TC_STREAM at M=4 with the planner's tiles: Kb cut on whole tiles,
    each split non-empty, at least 2 x 132 blocks."""
    plan = plan_gemm(4, k, n, "bfloat16")
    kb, nb = -(-k // plan.bk), -(-n // plan.bn)
    splits, chunk = gp.tc_stream_split(kb, nb)
    assert splits * chunk >= kb and (splits - 1) * chunk < kb
    assert nb * splits >= 2 * gt.H100_SMS


@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("k,n", OLMO)
def test_k6_takes_the_tma_bodies_at_olmo_shapes(m, k, n):
    """The planner's bm=64 (16 at M <= 16), bk=128, bn=64 "row" tiles take
    V_WGMMA above 16 rows and V_TC_STREAM at decode."""
    plan = plan_gemm(m, k, n, "bfloat16")
    want = gp.TC_STREAM if m <= 16 else gp.WGMMA
    assert gp.packed_variant(torch.bfloat16, m, plan.bm, plan.bk, plan.bn,
                             plan.layout_a, True) == want


@pytest.mark.parametrize("size", SWEEP)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k6_sweep_from_256_takes_wgmma(size, dtype):
    """In the sweep's tiling_packing, every size from 256 up packs 64 x 128
    x 64 tiles and takes V_WGMMA; below, the planner's smaller tiles take
    the general tensor-core body."""
    plan = plan_gemm(size, size, size, "bfloat16")
    got = gp.packed_variant(dtype, size, plan.bm, plan.bk, plan.bn,
                            plan.layout_a, True)
    if size >= 256:
        assert got == gp.WGMMA
    else:
        assert got in (gp.WGMMA, gt.MMA_DECODE, gt.MMA_PREFILL)


@pytest.mark.parametrize("m,bm,bk,bn,layout_a,aligned,want", [
    (512, 64, 128, 64, "row", True, gp.WGMMA),
    (512, 64, 128, 64, "col", True, gp.WGMMA),
    (17, 64, 64, 64, "col", True, gp.WGMMA),
    (4, 16, 128, 64, "row", True, gp.TC_STREAM),
    (1, 16, 64, 64, "row", True, gp.TC_STREAM),
    (4, 16, 128, 64, "col", True, gt.MMA_DECODE),
    (4, 16, 64, 32, "row", True, gt.MMA_DECODE),
    (65, 32, 64, 32, "row", True, gt.MMA_PREFILL),
    (65, 48, 64, 32, "col", True, gt.MMA_PREFILL),
    (100, 64, 32, 64, "row", True, gt.MMA_PREFILL),
    (100, 64, 128, 48, "row", True, gt.MMA_PREFILL),
    (512, 64, 128, 64, "row", False, gt.MMA_PREFILL),
    (4, 16, 128, 64, "row", False, gt.MMA_DECODE)])
def test_k6_odd_geometries_take_the_general_body(m, bm, bk, bn, layout_a,
                                                  aligned, want):
    """What the TMA bodies do not take (bm 16 / 32 / 48 above decode, bn
    other than 64, bk not a multiple of 64, "col" A at decode, unaligned
    stacks) goes to blocked_mma; nothing falls back to the plain version."""
    assert gp.packed_variant(torch.bfloat16, m, bm, bk, bn, layout_a,
                             aligned) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_k6_f32_and_int8_take_the_cuda_core_bodies(dtype):
    assert gp.packed_variant(dtype, 512, 64, 128, 64, "row", True) == gt.FMA
    assert gp.variant_name(gt.FMA, gt.FMA_STREAM) == "fma_stream"
    assert gp.variant_name(gp.WGMMA, 0) == "wgmma"


# -- on the card: both kernels against their plain versions ------------------

EDGE_M = [1, 4, 16, 17, 64, 65, 512]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _close(got, want, rtol, atol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert got.dtype == want.dtype
    assert bool(torch.all(err <= atol + rtol * want.float().abs())), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", EDGE_M)
@pytest.mark.parametrize("b", ["row-major", "table.t()", "row", "col"])
def test_cuda_k8_matches_plain_at_edge_shapes(m, b):
    """K8 in bf16 (f32 out, 1e-4) with N and K off the block, K=8192 at
    decode (split K), A offset by 5 elements (no 16-byte loads), the LM
    head's transposed view and packed B of bk 64, bn 32."""
    _cuda()
    rng = np.random.default_rng(m)
    k = 8192 if m <= 16 else 750
    n = 200
    a = torch.from_numpy(rng.standard_normal((m, k + 5), np.float32)).cuda()
    a = a.to(torch.bfloat16)[:, 5:]
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.05).cuda()
    w = w.to(torch.bfloat16)
    if b == "table.t()":
        w = w.t().contiguous().t()
    if b in ("row", "col"):
        bp = pk.pack_b_plain(w, 64, 32, b)
        _close(gv.matmul_vsx_like_packed(a, bp, n, layout_b=b,
                                         out_dtype=torch.float32),
               gv.matmul_vsx_like_packed_plain(a, bp, n, layout_b=b,
                                               out_dtype=torch.float32),
               1e-4, 1e-4)
    else:
        _close(gv.matmul_vsx_like(a, w, out_dtype=torch.float32),
               gv.matmul_vsx_like_plain(a, w, out_dtype=torch.float32),
               1e-4, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", EDGE_M)
@pytest.mark.parametrize("geometry", [(64, 128, 64), (16, 128, 64),
                                      (32, 64, 32), (48, 64, 32)])
@pytest.mark.parametrize("layouts", [("row", "row"), ("col", "col")])
def test_cuda_k6_matches_plain_at_edge_shapes(m, geometry, layouts):
    """K6 in bf16 (2e-2 / 1e-3) at the planner's tiles and odd ones, both
    layouts, with the full epilogue."""
    _cuda()
    bm, bk, bn = geometry
    la, lb = layouts
    rng = np.random.default_rng(m + bm)
    k, n = (8192 if m <= 16 else 750), 200
    a = torch.from_numpy(rng.standard_normal((m, k), np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.05).cuda()
    c = torch.from_numpy(rng.standard_normal((m, n), np.float32)).cuda()
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    ap = pk.pack_a_plain(a.to(torch.bfloat16), bm, bk, la)
    bp = pk.pack_b_plain(w.to(torch.bfloat16), bk, bn, lb)
    kw = dict(c=c, alpha=1.5, beta=0.5, bias=bias, epilogue="tanh",
              layout_a=la, layout_b=lb)
    _close(gp.gemm_packed(ap, bp, m, n, **kw),
           gp.gemm_packed_plain(ap, bp, m, n, **kw), 2e-2, 1e-3)


# -- K1 (gemm_packed_fused_a): the body a call takes -------------------------

from repro_torch.core.tile_format import ScaleSpec, TileFormat  # noqa: E402

BF16, F16, F32, I8 = torch.bfloat16, torch.float16, torch.float32, torch.int8


@pytest.mark.parametrize("a_dtype,b_dtype,gran,m,bk,bn,tma_ok,want", [
    # 16-bit A against tiles of its own type: the TMA bodies ...
    (BF16, "bfloat16", None, 4, 128, 64, True, "tc_stream"),
    (BF16, "bfloat16", None, 16, 128, 64, True, "tc_stream"),
    (BF16, "bfloat16", None, 17, 128, 64, True, "wgmma"),
    (F16, "float16", None, 1, 64, 64, True, "tc_stream"),
    (F16, "float16", None, 512, 64, 64, True, "wgmma"),
    # ... and blocked_mma for any other geometry or alignment.
    (BF16, "bfloat16", None, 4, 128, 64, False, "mma_general"),
    (BF16, "bfloat16", None, 512, 128, 64, False, "mma_general"),
    (BF16, "bfloat16", None, 4, 32, 64, True, "mma_general"),
    (BF16, "bfloat16", None, 17, 128, 32, True, "mma_general"),
    (F16, "float16", None, 64, 16, 16, True, "mma_general"),
    # f32 / int8 pairs on the CUDA cores.
    (F32, "float32", None, 16, 128, 64, True, "fma_stream"),
    (F32, "float32", None, 17, 128, 64, True, "fma_tiled"),
    (I8, "int8", None, 4, 64, 32, True, "fma_stream"),
    (I8, "int8", None, 33, 64, 32, False, "fma_tiled"),
    # 16-bit A against int8 / int4 tiles of that geometry: the quantized
    # TMA bodies (tests/test_torch_quant_geometry.py pins the rest) ...
    (BF16, "int8", "tile", 4, 128, 64, True, "tc_stream_q"),
    (BF16, "int4", "col", 512, 128, 64, True, "wgmma_q"),
    (F16, "int8", None, 64, 128, 64, True, "wgmma_q"),
    # ... and everything else the first port's quantized bodies.
    (F32, "int8", "tile", 4, 64, 64, True, "fma_quant"),
    (F32, "int4", "col", 512, 64, 64, True, "fma_quant"),
    (I8, "int4", None, 4, 64, 64, True, "fma_quant"),
    (BF16, "float32", None, 4, 128, 64, True, "fma_quant"),
    (F16, "bfloat16", None, 512, 128, 64, True, "fma_quant"),
    (F32, "bfloat16", None, 512, 128, 64, True, "fma_quant")])
def test_k1_body_follows_the_route_table(a_dtype, b_dtype, gran, m, bk, bn,
                                         tma_ok, want):
    scale = dict(scale=ScaleSpec(granularity=gran)) if gran else {}
    fmt = TileFormat(bk=bk, bn=bn, dtype=b_dtype, **scale)
    assert gp.fused_a_body(a_dtype, fmt, m, scaled=gran is not None,
                           tma_ok=tma_ok) == want


def _a_view(m, k, lda, offset=0, dtype=BF16):
    """An [m, k] view with row stride ``lda`` starting ``offset`` elements
    into its buffer."""
    return torch.zeros(m, lda + offset, dtype=dtype)[:, offset:offset + k]


@pytest.mark.parametrize("a,aligned", [
    (_a_view(4, 2048, 2048), True),
    (_a_view(4, 700, 704), True),            # a strided view, lda % 8 == 0
    (_a_view(512, 750, 752), True),
    (_a_view(4, 700, 700), False),           # lda * 2 bytes not % 16
    (_a_view(37, 300, 320, offset=5), False),  # base off 16 bytes
    (_a_view(4, 2048, 2048, offset=8), True),
    (_a_view(4, 64, 64, dtype=F32), True),
    (_a_view(4, 62, 62, dtype=F32), False)])
def test_k1_tma_alignment(a, aligned):
    """TMA takes 16-byte aligned bases and row strides of a multiple of 16
    bytes: a misaligned base or an odd lda goes to mma_general."""
    fmt = TileFormat(bk=128, bn=64, dtype="bfloat16")
    bp = torch.zeros(fmt.packed_shape(a.shape[1], 64), dtype=BF16)
    assert gp.tma_aligned(a, bp) == aligned
    if a.dtype == BF16:
        want = ("tc_stream" if a.shape[0] <= 16 else "wgmma") if aligned \
            else "mma_general"
        assert gp.fused_a_body(a.dtype, fmt, a.shape[0], scaled=False,
                               tma_ok=gp.tma_aligned(a, bp)) == want


def _k1_args(a, n, fmt, b_scales=None, **kw):
    """launch_args on CPU tensors (no launch): (args, body)."""
    k = a.shape[1]
    bp = torch.zeros(fmt.packed_shape(k, n),
                     dtype=getattr(torch, fmt.storage_dtype))
    out = torch.empty((a.shape[0], n), dtype=kw.pop("out_dtype", a.dtype))
    args, keep, body = gp.launch_args(
        a, bp, n, None, bm=kw.pop("bm", 64), alpha=1.0, beta=0.0,
        b_scales=b_scales, out=out, epilogue="none", bias=None, fmt=fmt,
        stream=None)
    return args, body, keep


# The C entry point's argument positions (gemm_packed.py _ARGTYPES).
BODY_ARG, PLAN_ARGS = 23, slice(28, 33)


@pytest.mark.parametrize("k,n", OLMO)
def test_k1_decode_takes_tc_stream_with_a_split_that_fills_the_card(k, n):
    """olmo-1b's decode (M=4, the planner's bk 128 bn 64 "row" tiles):
    tc_stream, Kb cut on whole packed tiles, each split non-empty, at least
    2 x 132 blocks, and a [splits, 4, N] f32 workspace when K is split."""
    fmt = TileFormat(bk=128, bn=64, dtype="bfloat16")
    args, body, keep = _k1_args(_a_view(4, k, k), n, fmt)
    fma_body, fma_tile, splits, chunk, ws = args[PLAN_ARGS]
    kb, nb = -(-k // 128), -(-n // 64)
    assert body == "tc_stream" and args[BODY_ARG] == 4
    assert (splits, chunk) == gp.tc_stream_split(kb, nb)
    assert splits * chunk >= kb and (splits - 1) * chunk < kb
    assert nb * splits >= 2 * gt.H100_SMS
    assert (ws is None) == (splits == 1)
    if splits > 1:
        assert tuple(keep[2].shape) == (splits, 4, n)


@pytest.mark.parametrize("k,n", OLMO)
def test_k1_prefill_takes_wgmma_unsplit(k, n):
    fmt = TileFormat(bk=128, bn=64, dtype="bfloat16")
    args, body, _ = _k1_args(_a_view(512, k, k), n, fmt)
    assert body == "wgmma" and args[BODY_ARG] == 3
    assert args[PLAN_ARGS] == (0, 0, 1, 0, None)


@pytest.mark.parametrize("m,want", [(4, "fma_stream"), (16, "fma_stream"),
                                    (17, "fma_tiled"), (512, "fma_tiled")])
@pytest.mark.parametrize("dtype", [F32, I8])
def test_k1_f32_and_int8_take_the_cuda_core_plan(m, want, dtype):
    """f32 and unscaled int8 take gemm_blocked.cuh's CUDA-core bodies with
    the plan of gemm_tiled.fma_geometry (splits on multiples of bk)."""
    k, n = 2048, 2048
    fmt = TileFormat(bk=128, bn=64, dtype=gp.dtype_name(dtype))
    out_dtype = torch.int32 if dtype == I8 else F32
    args, body, _ = _k1_args(_a_view(m, k, k, dtype=dtype), n, fmt,
                             out_dtype=out_dtype)
    plan = gt.fma_geometry(m, k, n, item=torch.empty(0, dtype=dtype)
                           .element_size(), b_kfast=False, align=128)
    assert body == want and args[BODY_ARG] == 6
    assert args[PLAN_ARGS][:4] == plan


@pytest.mark.parametrize("m,code", [(4, gp.MMA_DECODE), (512, gp.MMA_PREFILL)])
def test_k1_quantized_tiles_keep_the_first_bodies(m, code):
    """int4 tiles with col scales under a bf16 A that TMA cannot read (its
    base off 16 bytes): mma_quant, its decode or prefill tiles by
    pick_variant (an aligned A takes tc_stream_q / wgmma_q)."""
    fmt = TileFormat(bk=128, bn=64, dtype="int4",
                     scale=ScaleSpec(granularity="col"))
    args, body, _ = _k1_args(_a_view(m, 2048, 2048, offset=5), 8192, fmt,
                             b_scales=torch.ones(128))
    assert body == "mma_quant" and args[BODY_ARG] == code


def test_k1_counts_launches_by_body():
    assert set(gp.gemm_packed_fused_a.variants) == set(gp.FUSED_BODIES)


# -- on the card: K1 against its plain version at its bodies' edges ----------

K1_EDGE_M = [1, 4, 15, 16, 17, 37, 512]


def _k1_case(m, k, n, bk, layout, rng, dtype=BF16, nan_pad=True):
    """A as a view of a buffer whose columns past K hold NaN (row stride a
    multiple of 8), packed B of ``bk`` x 64 tiles in ``layout``."""
    lda = -(-k // 8) * 8 + 8
    buf = torch.full((m, lda), float("nan") if nan_pad else 0.0)
    buf[:, :k] = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    a = buf.cuda().to(dtype)[:, :k]
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.05)
    fmt = TileFormat(bk=bk, bn=64, layout=layout, dtype=gp.dtype_name(dtype))
    return a, pk.pack_b_plain(w.cuda().to(dtype), bk, 64, layout), fmt


def _k1_close(a, bp, n, fmt, rtol, atol, body, **kw):
    before = dict(gp.gemm_packed_fused_a.variants)
    got = gp.gemm_packed_fused_a(a, bp, n, b_format=fmt, **kw)
    ran = [v for v, c in gp.gemm_packed_fused_a.variants.items()
           if c != before[v]]
    assert ran == [body]
    _close(got, gp.gemm_packed_fused_a_plain(a, bp, n, b_format=fmt, **kw),
           rtol, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", K1_EDGE_M)
@pytest.mark.parametrize("k", [700, 750, 2048])
@pytest.mark.parametrize("bk,layout", [(128, "row"), (64, "col"),
                                       (128, "col"), (64, "row")])
def test_cuda_k1_tma_bodies_at_edge_shapes(m, k, bk, layout):
    """bf16 (2e-2 / 1e-3): a strided A whose columns past K hold NaN (the
    map is K wide), K tails whose last 64-deep box is padding, M on both
    sides of 16, N = 200 off the block, both layouts, bk 64 and 128."""
    _cuda()
    rng = np.random.default_rng(m * k + bk)
    a, bp, fmt = _k1_case(m, k, 200, bk, layout, rng)
    _k1_close(a, bp, 200, fmt, 2e-2, 1e-3,
              "tc_stream" if m <= 16 else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "silu", "tanh"])
def test_cuda_k1_epilogue_once_after_the_split(m, epilogue):
    """Every epilogue with bias, c, alpha and beta, at M=4 (K split, the
    epilogue after the reduction) and M=512, K=2048, N=2048."""
    _cuda()
    rng = np.random.default_rng(m)
    a, bp, fmt = _k1_case(m, 2048, 2048, 128, "row", rng)
    c = torch.from_numpy(rng.standard_normal((m, 2048), np.float32)).cuda()
    bias = torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).cuda()
    _k1_close(a, bp, 2048, fmt, 2e-2, 1e-3,
              "tc_stream" if m <= 16 else "wgmma", c=c, alpha=1.5, beta=0.5,
              bias=bias, epilogue=epilogue)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("n", [8192, 50304])
def test_cuda_k1_wide_n(m, n):
    """Blocks that walk several output tiles (M=512) and the LM head's 786
    stripes."""
    _cuda()
    a, bp, fmt = _k1_case(m, 2048, n, 128, "row", np.random.default_rng(n))
    _k1_close(a, bp, n, fmt, 2e-2, 1e-3, "tc_stream" if m <= 16 else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 37])
def test_cuda_k1_misaligned_a_takes_mma_general(m):
    _cuda()
    rng = np.random.default_rng(m)
    k, n = 300, 200
    buf = torch.from_numpy(rng.standard_normal((m, k + 20), np.float32))
    a = buf.cuda().to(BF16)[:, 5:k + 5]
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.05)
    fmt = TileFormat(bk=128, bn=64, dtype="bfloat16")
    bp = pk.pack_b_plain(w.cuda().to(BF16), 128, 64, "row")
    _k1_close(a, bp, n, fmt, 2e-2, 1e-3, "mma_general", epilogue="gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("m", K1_EDGE_M)
@pytest.mark.parametrize("dtype", [F32, I8])
def test_cuda_k1_cuda_core_bodies(m, dtype):
    """f32 (1e-4; full f32 on both sides, other orders) and int8 -> int32
    (exact) through fma_stream / fma_tiled, strided A, K = 750."""
    _cuda()
    rng = np.random.default_rng(m)
    k, n = 750, 200
    if dtype == I8:
        a = torch.from_numpy(rng.integers(-100, 100, (m, k + 8)).astype(
            np.int8)).cuda()[:, :k]
        w = torch.from_numpy(rng.integers(-100, 100, (k, n)).astype(np.int8))
        fmt = TileFormat(bk=64, bn=64, dtype="int8")
        bp = pk.pack_b_plain(w.cuda(), 64, 64, "row")
        kw, tol = dict(out_dtype=torch.int32), (0.0, 0.0)
    else:
        a, bp, fmt = _k1_case(m, k, n, 64, "col", rng, dtype=F32,
                              nan_pad=False)
        kw, tol = dict(epilogue="silu"), (1e-4, 1e-4)
    _k1_close(a, bp, n, fmt, *tol, "fma_stream" if m <= 16 else "fma_tiled",
              **kw)
