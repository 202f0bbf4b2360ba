"""Launch geometry of K7 (``gemm_tiled``): the pure-Python route
(``tiled_body``), the TMA alignment test over strided operands
(``tiled_tma_aligned``, after ``tiled_strides`` frees the strides of
extent-1 dims), the split-K plan and argument tuple that ``launch_args``
hands to ``csrc/gemm_tiled.cu``, the launch counts by body (pinned on CPU
tensors through a stubbed ``_kernel``, no launch), and the planted faults
of ``chip_smoke.py`` against the sources they edit; and, on a card
(``cuda`` marker), each body against the plain version at its edges. The
file imports no JAX: ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_tiled_geometry.py`` runs on the card."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import gemm_tiled as gt

ROOT = Path(__file__).resolve().parents[1]
BF16, F16, F32, I8 = torch.bfloat16, torch.float16, torch.float32, torch.int8
OLMO = [(2048, 2048), (2048, 8192), (8192, 2048), (2048, 50304)]

# The C entry point's argument positions (gemm_tiled.py _ARGTYPES).
A_STRIDES, B_STRIDES, VARIANT_ARG, PLAN_ARGS, MAX_BLOCKS_ARG = (
    slice(1, 3), slice(4, 6), 18, slice(19, 24), 24)


def _strided(shape, strides, offset=0, dtype=BF16):
    """A view with the given element strides into a zero buffer."""
    span = 1 + offset + sum((d - 1) * s for d, s in zip(shape, strides))
    return torch.zeros(span, dtype=dtype).as_strided(shape, strides, offset)


@pytest.mark.parametrize("dtype,m,tma_ok,want", [
    (BF16, 1, True, "tc_stream"),
    (BF16, 4, True, "tc_stream"),
    (BF16, 16, True, "tc_stream"),
    (BF16, 17, True, "wgmma"),
    (BF16, 512, True, "wgmma"),
    (F16, 4, True, "tc_stream"),
    (F16, 4096, True, "wgmma"),
    (BF16, 4, False, "mma_general"),
    (BF16, 512, False, "mma_general"),
    (F16, 16, False, "mma_general"),
    (F32, 4, True, "fma_stream"),
    (F32, 16, False, "fma_stream"),
    (F32, 17, True, "fma_tiled"),
    (I8, 4, True, "fma_stream"),
    (I8, 512, False, "fma_tiled")])
def test_tiled_body_follows_the_route_table(dtype, m, tma_ok, want):
    """bf16 / f16 on operands TMA can read: tc_stream up to 16 rows, wgmma
    above; other bf16 / f16 operands mma_general; f32 and int8 keep the
    CUDA-core bodies whatever the alignment."""
    assert gt.tiled_body(dtype, m, tma_ok) == want


@pytest.mark.parametrize("a,b,aligned", [
    (torch.zeros(4, 2048, dtype=BF16), torch.zeros(2048, 2048, dtype=BF16),
     True),
    # the raw LM head: B = table.t(), k-contiguous
    (torch.zeros(4, 2048, dtype=BF16),
     torch.zeros(50304, 2048, dtype=BF16).t(), True),
    # B a column slice of a wider matrix (ldb 256 > N = 200)
    (torch.zeros(4, 704, dtype=BF16)[:, :700],
     torch.zeros(700, 256, dtype=BF16)[:, :200], True),
    # table.t() of a slice of a wider table (row stride 704 > K = 700)
    (torch.zeros(4, 704, dtype=BF16)[:, :700],
     torch.zeros(200, 704, dtype=BF16)[:, :700].t(), True),
    # A contiguous at K = 700: its row stride 1400 bytes is off 16
    (torch.zeros(4, 700, dtype=BF16),
     torch.zeros(700, 256, dtype=BF16)[:, :200], False),
    # A a NaN-padded view (lda 704 > K)
    (torch.zeros(17, 704, dtype=BF16)[:, :700],
     torch.zeros(700, 200, dtype=BF16), True),
    # A offset by 5 elements: base off 16 bytes
    (torch.zeros(4, 2053, dtype=BF16)[:, 5:],
     torch.zeros(2048, 200, dtype=BF16), False),
    # a transposed A (k-stride 4)
    (torch.zeros(2048, 4, dtype=BF16).t(),
     torch.zeros(2048, 200, dtype=BF16), False),
    # odd N: B's row stride 201 * 2 bytes
    (torch.zeros(4, 2048, dtype=BF16), torch.zeros(2048, 201, dtype=BF16),
     False),
    # odd K under table.t(): table's row stride 701 * 2 bytes
    (torch.zeros(4, 704, dtype=BF16)[:, :701],
     torch.zeros(200, 701, dtype=BF16).t(), False),
    # B's 200-wide slice of a 203-wide matrix: row stride off 16 bytes
    (torch.zeros(4, 704, dtype=BF16)[:, :700],
     torch.zeros(700, 203, dtype=BF16)[:, :200], False),
    # B's base off 16 bytes
    (torch.zeros(4, 2048, dtype=BF16),
     torch.zeros(2048 * 200 + 1, dtype=BF16)[1:].view(2048, 200), False),
    # rows that overlap: a broadcast B (k-stride 0)
    (torch.zeros(4, 2048, dtype=BF16),
     torch.zeros(1, 200, dtype=BF16).expand(2048, 200), False),
    # extent-1 dims are never stepped: their strides do not count
    (_strided((1, 2048), (7, 1)), torch.zeros(2048, 200, dtype=BF16), True),
    (torch.zeros(4, 2048, dtype=BF16), _strided((2048, 1), (1, 3)), True),
    (torch.zeros(4, 2048, dtype=BF16),
     torch.zeros(2048, 64, dtype=BF16)[:, :1], True),
    (torch.zeros(4, 8, dtype=BF16)[:, :1], _strided((1, 200), (3, 1)), True),
    (torch.zeros(4, 8, dtype=BF16)[:, :1], _strided((1, 200), (1, 5)), False),
    (_strided((1, 1), (3, 5)), _strided((1, 1), (7, 9)), True)])
def test_tiled_tma_alignment(a, b, aligned):
    """TMA takes 16-byte aligned bases, a k-contiguous A and an n- or
    k-contiguous B, with row strides that are multiples of 16 bytes and do
    not overlap; the rest routes to mma_general."""
    assert gt.tiled_tma_aligned(a, b) == aligned
    want = ("tc_stream" if a.shape[0] <= 16 else "wgmma") if aligned \
        else "mma_general"
    assert gt.tiled_body(a.dtype, a.shape[0], aligned) == want


@pytest.mark.parametrize("a,b,want", [
    # nothing of extent 1: the strides as they are
    (torch.zeros(4, 700, dtype=BF16), torch.zeros(200, 704)[:, :700].t(),
     (700, 1, 1, 704)),
    # [1, K] A: a row stride of K rounded up to 16 bytes
    (_strided((1, 700), (3, 1)), torch.zeros(700, 200, dtype=BF16),
     (704, 1, 200, 1)),
    # [M, 1] A: a unit k-stride
    (_strided((4, 1), (16, 9)), torch.zeros(1, 200, dtype=BF16),
     (16, 1, 200, 1)),
    # [K, 1] B with a unit k-stride: k-contiguous, rows K rounded up
    (torch.zeros(4, 700, dtype=BF16), _strided((700, 1), (1, 3)),
     (700, 1, 1, 704)),
    # [K, 1] B that steps k by a row: n-contiguous
    (torch.zeros(4, 700, dtype=BF16), torch.zeros(700, 64)[:, :1],
     (700, 1, 64, 1)),
    # [1, N] B stepping n by 1: n-contiguous, rows N rounded up (A's rows
    # of one element stay 1 apart: stepped, so kept)
    (torch.zeros(4, 1, dtype=BF16), _strided((1, 200), (3, 1)),
     (1, 1, 200, 1)),
    # [1, N] B of a transposed view: k-contiguous
    (torch.zeros(4, 8, dtype=BF16)[:, :1], _strided((1, 200), (5, 16)),
     (8, 1, 1, 16)),
    # f32: 16 bytes are 4 elements
    (_strided((1, 7), (3, 1), dtype=F32), torch.zeros(7, 1), (8, 1, 1, 8))])
def test_tiled_strides_free_the_strides_of_extent_one_dims(a, b, want):
    assert gt.tiled_strides(a, b) == want


def _args(a, b, c=None, *, single_block=False, out_dtype=None, **kw):
    """launch_args on CPU tensors (no launch): (args, keep, body)."""
    out = torch.empty((a.shape[0], b.shape[1]),
                      dtype=out_dtype or (c.dtype if c is not None else a.dtype))
    return gt.launch_args(a, b, c, alpha=kw.pop("alpha", 1.0),
                          beta=kw.pop("beta", 0.0), out=out,
                          epilogue=kw.pop("epilogue", "none"),
                          bias=kw.pop("bias", None), single_block=single_block,
                          stream=None)


@pytest.mark.parametrize("kb,nb", [
    (32, 32), (32, 128), (128, 32), (32, 786),   # olmo-1b's four shapes
    (11, 4), (1, 1), (1, 300), (3, 7), (200, 3), (97, 5)])
def test_tc_stream_split_covers_kb_once(kb, nb):
    """Kb 64-deep boxes cut into non-empty chunks that cover it once, at
    least 2 x 132 blocks where Kb allows, one split once the stripes alone
    fill the card twice."""
    splits, chunk = gt.tc_stream_split(kb, nb)
    assert chunk >= 1 and splits * chunk >= kb and (splits - 1) * chunk < kb
    assert nb * splits >= min(2 * gt.H100_SMS, nb * kb)
    if nb >= 2 * gt.H100_SMS:
        assert splits == 1


@pytest.mark.parametrize("k,n", OLMO)
@pytest.mark.parametrize("b", ["row-major", "table.t()"])
def test_decode_takes_tc_stream_with_a_split_that_fills_the_card(k, n, b):
    """olmo-1b's decode (M=4): tc_stream, K split from the 64-column stripes
    and Kb only (>= 264 blocks), a [splits, M, N] f32 workspace when split;
    table.t() is read as it lies (sbk 1, sbn K)."""
    a = torch.zeros(4, k, dtype=BF16)
    w = (torch.zeros(k, n, dtype=BF16) if b == "row-major"
         else torch.zeros(n, k, dtype=BF16).t())
    args, keep, body = _args(a, w)
    splits, chunk, ws = args[21], args[22], args[23]
    assert body == "tc_stream" and args[VARIANT_ARG] == gt.TC_STREAM
    assert (splits, chunk) == gt.tc_stream_split(k // 64, n // 64)
    assert -(-n // 64) * splits >= 2 * gt.H100_SMS
    assert args[MAX_BLOCKS_ARG] == gt.ALL_BLOCKS
    assert args[B_STRIDES] == ((n, 1) if b == "row-major" else (1, k))
    if splits > 1:
        assert tuple(keep[2].shape) == (splits, 4, n) and keep[2].dtype == F32
        assert ws == keep[2].data_ptr()
    else:
        assert keep[2] is None and ws is None


def test_k_700_splits_on_its_part_padding_last_box():
    """K = 700 is 11 boxes, the last part padding: 4 stripes at N = 200
    split it in 11 chunks of one box."""
    a = torch.zeros(4, 704, dtype=BF16)[:, :700]
    args, keep, body = _args(a, torch.zeros(700, 256, dtype=BF16)[:, :200])
    assert body == "tc_stream" and (args[21], args[22]) == (11, 1)
    assert tuple(keep[2].shape) == (11, 4, 200)


@pytest.mark.parametrize("k,n", OLMO)
def test_prefill_takes_wgmma_unsplit(k, n):
    args, keep, body = _args(torch.zeros(512, k, dtype=BF16),
                             torch.zeros(k, n, dtype=BF16))
    assert body == "wgmma" and args[VARIANT_ARG] == gt.WGMMA
    assert args[PLAN_ARGS] == (0, 0, 1, 0, None) and keep[2] is None


@pytest.mark.parametrize("m,body", [(4, "tc_stream"), (16, "tc_stream"),
                                    (512, "wgmma"), (4096, "wgmma")])
def test_single_block_gives_grid_one_and_no_split(m, body):
    """intrinsic: one block (max_blocks 1) that walks every item, K unsplit
    (tc_stream covers Kb in one chunk)."""
    a = torch.zeros(m, 2048, dtype=BF16)
    args, keep, got = _args(a, torch.zeros(2048, 2048, dtype=BF16),
                            single_block=True)
    assert got == body and args[MAX_BLOCKS_ARG] == 1
    assert args[21] == 1 and keep[2] is None
    if body == "tc_stream":
        assert args[22] == 32


@pytest.mark.parametrize("dtype,m", [(F32, 4), (F32, 512), (I8, 4), (I8, 512)])
def test_single_block_cuda_core_bodies_do_not_split(dtype, m):
    a = torch.zeros(m, 2048, dtype=dtype)
    args, _, body = _args(a, torch.zeros(2048, 2048, dtype=dtype),
                          single_block=True, out_dtype=(
                              torch.int32 if dtype == I8 else None))
    assert body == ("fma_stream" if m <= 16 else "fma_tiled")
    assert args[VARIANT_ARG] == gt.FMA and args[21] == 1
    assert args[MAX_BLOCKS_ARG] == 1


@pytest.mark.parametrize("m,variant", [(4, gt.MMA_DECODE), (37, gt.MMA_PREFILL)])
def test_misaligned_a_takes_mma_general(m, variant):
    """An A offset by 5 elements: blocked_mma's tiles by M, any strides."""
    a = torch.zeros(m, 320, dtype=BF16)[:, 5:305]
    args, keep, body = _args(a, torch.zeros(300, 200, dtype=BF16))
    assert body == "mma_general" and args[VARIANT_ARG] == variant
    assert args[A_STRIDES] == (320, 1) and keep[2] is None


@pytest.mark.parametrize("dtype", [F32, I8])
def test_f32_and_int8_keep_the_cuda_core_plan(dtype):
    """f32 / int8 take fma_geometry's plan, k-contiguous B for table.t()."""
    a = torch.zeros(4, 2048, dtype=dtype)
    b = torch.zeros(2048, 2048, dtype=dtype).t()
    out_dtype = torch.int32 if dtype == I8 else None
    args, keep, body = _args(a, b, out_dtype=out_dtype)
    plan = gt.fma_geometry(4, 2048, 2048, item=a.element_size(), b_kfast=True)
    assert body == "fma_stream" and args[VARIANT_ARG] == gt.FMA
    assert args[PLAN_ARGS][:4] == plan
    assert tuple(keep[2].shape) == (plan[2], 4, 2048)


def test_epilogue_operands_are_converted_and_kept():
    """C and the bias go to the kernel as contiguous f32, beta only with a
    C, and outlive the launch in ``keep``."""
    a, b = torch.zeros(4, 64, dtype=BF16), torch.zeros(64, 32, dtype=BF16)
    c, bias = torch.ones(32, 4).t(), torch.ones(32, dtype=BF16)
    args, keep, _ = _args(a, b, c, beta=0.5, bias=bias, epilogue="gelu")
    c32, bias32, _ = keep
    assert c32.dtype == bias32.dtype == F32 and c32.is_contiguous()
    assert args[10:15] == (bias32.data_ptr(), c32.data_ptr(), 32, 1.0, 0.5)
    args, _, _ = _args(a, b, beta=0.5)
    assert args[11] is None and args[14] == 0.0


@pytest.mark.parametrize("bad", ["no_contract", "3d", "dtypes", "out_strided",
                                 "k_zero", "out_dtype", "c_shape", "bias_shape"])
def test_launch_args_refuse_what_the_bodies_do_not_take(bad):
    a, b = torch.zeros(4, 64, dtype=BF16), torch.zeros(64, 32, dtype=BF16)
    c = bias = None
    out = torch.empty(4, 32, dtype=BF16)
    if bad == "no_contract":
        b = torch.zeros(63, 32, dtype=BF16)
    if bad == "3d":
        a = torch.zeros(1, 4, 64, dtype=BF16)
    if bad == "dtypes":
        b = b.to(F16)
    if bad == "out_strided":
        out = torch.empty(4, 64, dtype=BF16)[:, ::2]
    if bad == "k_zero":
        a, b = torch.zeros(4, 0, dtype=BF16), torch.zeros(0, 32, dtype=BF16)
    if bad == "out_dtype":
        out = torch.empty(4, 32, dtype=torch.float64)
    if bad == "c_shape":
        c = torch.zeros(4, 31)
    if bad == "bias_shape":
        bias = torch.zeros(33)
    with pytest.raises(ValueError):
        gt.launch_args(a, b, c, alpha=1.0, beta=1.0, out=out, epilogue="none",
                       bias=bias, single_block=False, stream=None)


@pytest.mark.parametrize("a_dtype,m,b,want", [
    (BF16, 4, "table.t()", "tc_stream"),
    (BF16, 40, "row-major", "wgmma"),
    (BF16, 4, "offset", "mma_general"),
    (F32, 4, "row-major", "fma_stream"),
    (F32, 40, "table.t()", "fma_tiled")])
def test_launches_are_counted_by_body(monkeypatch, a_dtype, m, b, want):
    """Through a stubbed ``_kernel``: one launch adds one to ``launches`` and
    to ``variants[body]``, the body whose code the C entry point was handed;
    a failed launch raises, names its body and counts nothing."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 1
    monkeypatch.setattr(gt, "_kernel", lambda: kernel)
    monkeypatch.setattr(gt.gemm_tiled, "launches", 0)
    monkeypatch.setattr(gt.gemm_tiled, "variants",
                        dict.fromkeys(gt.TILED_BODIES, 0))
    k, n = 256, 128
    w = {"table.t()": torch.zeros(n, k, dtype=a_dtype).t(),
         "row-major": torch.zeros(k, n, dtype=a_dtype),
         "offset": torch.zeros(k * n + 5, dtype=a_dtype)[5:].view(k, n)}[b]
    kw = dict(alpha=1.0, beta=0.0, out_dtype=a_dtype, epilogue="none",
              bias=None, single_block=False, stream=None)
    out = gt._launch(torch.zeros(m, k, dtype=a_dtype), w, None, **kw)
    assert tuple(out.shape) == (m, n) and out.dtype == a_dtype
    assert gt.gemm_tiled.launches == 1 and gt.gemm_tiled.variants[want] == 1
    assert sum(gt.gemm_tiled.variants.values()) == 1
    code = {"tc_stream": gt.TC_STREAM, "wgmma": gt.WGMMA,
            "mma_general": gt.MMA_DECODE}.get(want, gt.FMA)
    assert calls[0][VARIANT_ARG] == code
    with pytest.raises(RuntimeError, match=want):
        gt._launch(torch.zeros(m, k, dtype=a_dtype), w, None, **kw)
    assert gt.gemm_tiled.launches == 1
    assert sum(gt.gemm_tiled.variants.values()) == 1


def test_empty_outputs_launch_nothing(monkeypatch):
    monkeypatch.setattr(gt, "_kernel", lambda: pytest.fail("launched"))
    monkeypatch.setattr(gt.gemm_tiled, "launches", 0)
    kw = dict(alpha=1.0, beta=0.0, out_dtype=BF16, epilogue="none",
              bias=None, single_block=False, stream=None)
    for a, b in ((torch.zeros(0, 64, dtype=BF16), torch.zeros(64, 32, dtype=BF16)),
                 (torch.zeros(4, 64, dtype=BF16), torch.zeros(64, 0, dtype=BF16))):
        assert gt._launch(a, b, None, **kw).numel() == 0
    assert gt.gemm_tiled.launches == 0


def test_gemm_tiled_counts_every_body():
    assert set(gt.gemm_tiled.variants) == set(gt.TILED_BODIES)
    assert len(gt.TILED_BODIES) == 5


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_counters_reset_zeroes_k7_bodies():
    cs = _chip_smoke()
    counters = cs.Counters([gt.gemm_tiled])
    saved = (gt.gemm_tiled.launches, dict(gt.gemm_tiled.variants))
    try:
        gt.gemm_tiled.launches, gt.gemm_tiled.variants["wgmma"] = 3, 2
        counters.reset()
        assert counters.read() == {"gemm_tiled": 0}
        assert counters.variants() == {"gemm_tiled": dict.fromkeys(
            gt.TILED_BODIES, 0)}
    finally:
        gt.gemm_tiled.launches = saved[0]
        gt.gemm_tiled.variants.update(saved[1])


@pytest.mark.parametrize("i", range(11))
def test_planted_faults_edit_their_sources_exactly_once(i):
    """``chip_smoke.py --planted-faults`` copies a source and its headers
    and applies each fault's edits to its copy: every edited text must sit
    in its target exactly once, so that a fault cannot silently miss."""
    faults = _chip_smoke().GEMM_FAULTS
    assert len(faults) == 11
    name, kernel, target, edits = faults[i]
    assert (build.CSRC / f"{kernel}.cu").exists()
    text = (build.CSRC / target).read_text()
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        assert old != new
        text = text.replace(old, new)


def test_k7_faults_are_planted_in_k7():
    faults = [f for f in _chip_smoke().GEMM_FAULTS if f[0].startswith("K7")]
    assert len(faults) == 3
    assert all(f[1:3] == ("gemm_tiled", "gemm_tiled.cu") for f in faults)


# -- on the card: K7 against its plain version at its bodies' edges ----------

K7_EDGE_M = [1, 4, 16, 17, 64, 512]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _padded(rng, rows, cols, dtype=BF16, std=1.0):
    """[rows, cols] view of a buffer whose columns past ``cols`` hold NaN
    (row stride a multiple of 8)."""
    buf = torch.full((rows, -(-cols // 8) * 8 + 8), math.nan)
    buf[:, :cols] = torch.from_numpy(
        rng.standard_normal((rows, cols), np.float32) * std)
    return buf.cuda().to(dtype)[:, :cols]


def _weight(rng, k, n, layout, dtype=BF16):
    """B [K, N]: a column slice whose columns past N hold NaN, or table.t()
    of an [N, K] slice whose columns past K hold NaN."""
    if layout == "row-major":
        return _padded(rng, k, n, dtype, 0.05)
    return _padded(rng, n, k, dtype, 0.05).t()


def _close(a, b, body, rtol=2e-2, atol=1e-3, **kw):
    """The kernel against the plain version (bf16 / f16 output 2e-2 / 1e-3:
    f32 sums in other orders, one rounding; f32 1e-4) on the body it must
    take; a freed NaN buffer of the output's size lies where the output is
    allocated, so an element the kernel does not store shows."""
    out_dtype = kw.get("out_dtype") or (kw["c"].dtype if "c" in kw else a.dtype)
    poison = torch.full((a.shape[0], b.shape[1]), math.nan if
                        out_dtype.is_floating_point else -2 ** 31,
                        device="cuda", dtype=out_dtype)
    del poison
    before = dict(gt.gemm_tiled.variants)
    got = gt.gemm_tiled(a, b, **kw)
    torch.cuda.synchronize()
    ran = [v for v, c in gt.gemm_tiled.variants.items() if c != before[v]]
    assert ran == [body]
    want = gt.gemm_tiled_plain(a, b, **kw)
    err = (got.float() - want.float()).abs()
    assert bool(torch.all(err <= atol + rtol * want.float().abs())), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", K7_EDGE_M)
@pytest.mark.parametrize("k", [700, 2048, 8192])
@pytest.mark.parametrize("layout", ["row-major", "table.t()"])
def test_cuda_k7_tma_bodies_at_edge_shapes(m, k, layout):
    """bf16: a NaN-padded A (its map K wide), B with NaN past N (row-major)
    or past K (table.t(): the map over table K wide), K = 700's part-padding
    last box, K = 8192 split at decode, N = 200's ragged last stripe."""
    _cuda()
    rng = np.random.default_rng(m * k)
    _close(_padded(rng, m, k), _weight(rng, k, 200, layout),
           "tc_stream" if m <= 16 else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (4, 700, 17000),
                                   (512, 2048, 2048)])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "silu", "tanh"])
def test_cuda_k7_epilogue_once(m, k, n, epilogue):
    """Every epilogue with bias, c, alpha and beta: after the split sum (M=4,
    N=2048), unsplit (N=17000: 266 stripes) and on wgmma (M=512)."""
    _cuda()
    rng = np.random.default_rng(m + n)
    c = torch.from_numpy(rng.standard_normal((m, n), np.float32)).cuda()
    bias = torch.from_numpy(rng.standard_normal(n, np.float32)).cuda()
    _close(_padded(rng, m, k), _weight(rng, k, n, "table.t()"),
           "tc_stream" if m <= 16 else "wgmma", c=c, alpha=1.5, beta=0.5,
           bias=bias, epilogue=epilogue)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("n", [8192, 50304])
@pytest.mark.parametrize("layout", ["row-major", "table.t()"])
def test_cuda_k7_wide_n(m, n, layout):
    _cuda()
    rng = np.random.default_rng(n + m)
    _close(_padded(rng, m, 2048), _weight(rng, 2048, n, layout),
           "tc_stream" if m <= 16 else "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (512, 700, 200)])
@pytest.mark.parametrize("layout", ["row-major", "table.t()"])
def test_cuda_k7_one_block(m, k, n, layout):
    """single_block: one block walks 32 stripes (M=4) or 8 tiles (M=512)."""
    _cuda()
    rng = np.random.default_rng(m + k)
    c = torch.from_numpy(rng.standard_normal((m, n), np.float32)).cuda()
    _close(_padded(rng, m, k), _weight(rng, k, n, layout),
           "tc_stream" if m <= 16 else "wgmma", single_block=True, c=c,
           alpha=0.5, beta=2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("layout", ["row-major", "table.t()"])
def test_cuda_k7_f16_and_f32_output(m, layout):
    _cuda()
    rng = np.random.default_rng(m)
    body = "tc_stream" if m <= 16 else "wgmma"
    _close(_padded(rng, m, 700, F16), _weight(rng, 700, 200, layout, F16), body)
    _close(_padded(rng, m, 2048), _weight(rng, 2048, 200, layout), body,
           1e-4, 1e-4, out_dtype=F32)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 37])
def test_cuda_k7_misaligned_a_takes_mma_general(m):
    _cuda()
    rng = np.random.default_rng(m)
    a = _padded(rng, m, 320)[:, 5:305]
    _close(a, _weight(rng, 300, 200, "row-major"), "mma_general",
           epilogue="gelu")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("dtype", [F32, I8])
def test_cuda_k7_cuda_core_bodies(m, dtype):
    _cuda()
    rng = np.random.default_rng(m)
    body = "fma_stream" if m <= 16 else "fma_tiled"
    if dtype == F32:
        _close(_padded(rng, m, 700, F32), _weight(rng, 700, 200, "table.t()", F32),
               body, 1e-4, 1e-4, epilogue="silu")
    else:
        a = torch.from_numpy(rng.integers(-100, 100, (m, 750), np.int8)).cuda()
        b = torch.from_numpy(rng.integers(-100, 100, (750, 200), np.int8)).cuda()
        _close(a, b, body, 0.0, 0.0, out_dtype=torch.int32)
