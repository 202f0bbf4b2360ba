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
