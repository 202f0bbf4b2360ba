"""The quantized TMA bodies of K1 (``gemm_packed_fused_a``) and K2 / K3
(``gemm_grouped_packed_ragged`` / ``gemm_grouped_packed``), without JAX:

  * the route (``fused_a_body``, ``grouped_body``): bf16 / f16 A against
    int8 / int4 tiles (tile, col or no scales) with bn 64 and bk % 64 == 0
    on TMA-aligned operands take ``tc_stream_q`` up to 16 rows and
    ``wgmma_q`` above; every other quantized pair keeps the earlier bodies;
  * ``launch_args``: body codes, the split on whole k-tiles and the
    workspace for tile and col scales; launches counted by body through a
    stubbed ``_kernel``;
  * a CPU model of ``csrc/gemm_quant.cuh``'s arithmetic: the widening of a
    pair of stored values (exact for every int8 and int4 value) and the
    fragment addressing over a swizzled box (each stored value read once,
    into the mma slot of its k and the column ``qcol`` names);
  * chip_smoke's planted quantized faults sit in their sources once;
  * on a card (``cuda`` marker), both bodies against the plain versions at
    their edges, and the quantized card tests of ``test_torch_gemm_packed``
    and ``test_torch_moe`` (which import JAX, absent on the card's machine).
"""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import tile_format
from repro_torch.core.tile_format import ScaleSpec, TileFormat
from repro_torch.kernels import build
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import gemm_packed as gp
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
BF16, F16, F32, I8 = torch.bfloat16, torch.float16, torch.float32, torch.int8
QUANT_SRC = (build.CSRC / "gemm_quant.cuh").read_text()


def _fmt(dtype, gran, bk=128, bn=64, layout="row"):
    scale = dict(scale=ScaleSpec(granularity=gran)) if gran else {}
    return TileFormat(bk=bk, bn=bn, layout=layout, dtype=dtype, **scale)


# -- the route -----------------------------------------------------------------

ROUTE = [
    # (a dtype, b dtype, scale, rows, bk, bn, tma_ok, K1 body, K2 body)
    (BF16, "int8", "tile", 1, 128, 64, True, "tc_stream_q", "tc_stream_q"),
    (BF16, "int8", "tile", 16, 128, 64, True, "tc_stream_q", "tc_stream_q"),
    (BF16, "int8", "tile", 17, 128, 64, True, "wgmma_q", "wgmma_q"),
    (BF16, "int8", "col", 512, 64, 64, True, "wgmma_q", "wgmma_q"),
    (BF16, "int4", "tile", 4, 64, 64, True, "tc_stream_q", "tc_stream_q"),
    (BF16, "int4", "col", 160, 128, 64, True, "wgmma_q", "wgmma_q"),
    (F16, "int4", "col", 8, 128, 64, True, "tc_stream_q", "tc_stream_q"),
    (F16, "int8", None, 300, 192, 64, True, "wgmma_q", "wgmma_q"),
    (BF16, "int8", None, 4, 128, 64, True, "tc_stream_q", "tc_stream_q"),
    # What the TMA bodies do not take keeps the earlier bodies: a misaligned
    # A, tiles narrower than 64 or shallower than a 64-deep box ...
    (BF16, "int8", "tile", 4, 128, 64, False, "mma_quant", "mma_sync"),
    (BF16, "int4", "col", 512, 128, 64, False, "mma_quant", "mma_sync"),
    (BF16, "int8", "tile", 4, 128, 32, True, "mma_quant", "mma_sync"),
    (BF16, "int8", "tile", 40, 32, 64, True, "mma_quant", "mma_sync"),
    (BF16, "int8", "tile", 4, 32, 64, True, "fma_quant", "fma"),
    # ... f32 A (full f32 on the CUDA cores), int8 A (i32 accumulators) and
    # mixed float types.
    (F32, "int8", "tile", 4, 128, 64, True, "fma_quant", "fma"),
    (F32, "int4", "col", 512, 128, 64, True, "fma_quant", "fma"),
    (I8, "int4", None, 4, 128, 64, True, "fma_quant", "fma"),
    (BF16, "float16", None, 4, 128, 64, True, "fma_quant", "fma")]


@pytest.mark.parametrize("a_dtype,b_dtype,gran,m,bk,bn,tma_ok,k1,k2", ROUTE)
def test_quantized_route(a_dtype, b_dtype, gran, m, bk, bn, tma_ok, k1, k2):
    fmt = _fmt(b_dtype, gran, bk, bn)
    assert gp.fused_a_body(a_dtype, fmt, m, scaled=gran is not None,
                           tma_ok=tma_ok) == k1
    assert gg.grouped_body(a_dtype, fmt, m, scaled=gran is not None,
                           tma_ok=tma_ok) == k2


@pytest.mark.parametrize("shape", [(2048, 2048), (2048, 8192), (8192, 2048),
                                   (2048, 50304), (6144, 16384),
                                   (16384, 6144), (6144, 1024)])
@pytest.mark.parametrize("quantize", ["int8", "int8:col", "int4", "int4:col"])
def test_planned_quantized_tiles_take_the_new_bodies(shape, quantize):
    """The planner's quantized tiles at every olmo-1b and mixtral-8x22b
    weight shape are bk 128, bn 64, "row": the new bodies' geometry."""
    from repro_torch.core.layered import _parse_quantize
    from repro_torch.core.planner import plan_gemm
    b_dtype, gran = _parse_quantize(quantize)
    plan = plan_gemm(1024, *shape, "bfloat16", b_dtype=b_dtype,
                     scale_granularity=gran)
    fmt = plan.b_format
    assert (fmt.bk, fmt.bn, fmt.layout, fmt.dtype) == (128, 64, "row", b_dtype)
    assert fmt.col_scaled == (gran == "col")
    for m, want in ((4, "tc_stream_q"), (512, "wgmma_q")):
        assert gp.fused_a_body(BF16, fmt, m, scaled=True, tma_ok=True) == want


# -- launch arguments ----------------------------------------------------------

K1_BODY_ARG, K1_SCALE_MODE_ARG, K1_PLAN_ARGS = 23, 13, slice(28, 33)
K2_BODY_ARG, K2_SCALE_MODE_ARG, K2_SPLIT_ARGS = 30, 20, slice(31, 34)


def _k1_args(m, k, n, fmt, aligned=True):
    lda = -(-k // 8) * 8 + 8   # row stride a multiple of 16 bytes
    a = torch.zeros(m, lda, dtype=BF16)[:, (0 if aligned else 3):][:, :k]
    bp = torch.zeros(fmt.packed_shape(k, n), dtype=getattr(torch,
                                                           fmt.storage_dtype))
    nb, kb = bp.shape[:2]
    sc = (torch.ones((nb,) if fmt.col_scaled else (nb, kb))
          if fmt.is_quantized else None)
    out = torch.empty((m, n), dtype=BF16)
    return gp.launch_args(a, bp, n, None, bm=64, alpha=1.0, beta=0.0,
                          b_scales=sc, out=out, epilogue="none", bias=None,
                          fmt=fmt, stream=None)


@pytest.mark.parametrize("gran,mode", [("tile", 1), ("col", 2), (None, 0)])
@pytest.mark.parametrize("qd", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 2048), (1, 8192, 2048),
                                   (16, 2048, 50304), (4, 700, 200)])
def test_k1_decode_splits_on_tile_edges(qd, gran, mode, m, k, n):
    """tc_stream_q: code 7, Kb cut into chunks of whole k-tiles as
    tc_stream cuts it (each split non-empty, K covered once, at least two
    blocks an SM as far as Kb allows) and a [splits, M, N] f32 workspace
    when it splits, for tile and col scales alike."""
    fmt = _fmt(qd, gran, bk=128 if k % 128 == 0 else 64)
    args, keep, body = _k1_args(m, k, n, fmt)
    kb, nb = -(-k // fmt.bk), -(-n // 64)
    splits, chunk = gt.tc_stream_split(kb, nb)
    assert body == "tc_stream_q" and args[K1_BODY_ARG] == 7
    assert args[K1_SCALE_MODE_ARG] == mode
    assert args[K1_PLAN_ARGS][2:4] == (splits, chunk)
    assert splits * chunk >= kb > (splits - 1) * chunk
    assert nb * splits >= min(2 * gt.H100_SMS, nb * kb)
    ws = keep[2]
    if splits > 1:
        assert tuple(ws.shape) == (splits, m, n) and ws.dtype == F32
        assert args[K1_PLAN_ARGS][4] == ws.data_ptr()
    else:
        assert ws is None and args[K1_PLAN_ARGS][4] is None


@pytest.mark.parametrize("qd,gran", [("int8", "tile"), ("int4", "col")])
def test_k1_prefill_takes_wgmma_q_unsplit(qd, gran):
    args, keep, body = _k1_args(512, 2048, 8192, _fmt(qd, gran))
    assert body == "wgmma_q" and args[K1_BODY_ARG] == 8
    assert args[K1_PLAN_ARGS][2:] == (1, 0, None) and keep[2] is None


def test_k1_misaligned_a_keeps_mma_quant():
    args, _, body = _k1_args(4, 2048, 2048, _fmt("int8", "tile"),
                             aligned=False)
    assert body == "mma_quant" and args[K1_BODY_ARG] == gp.MMA_DECODE


def _k2_args(e, s, c, k, n, fmt, pair, counts=True):
    a = torch.zeros(e, s, c, -(-k // 8) * 8, dtype=BF16)[..., :k]
    store = getattr(torch, fmt.storage_dtype)
    bp = torch.zeros((e, *fmt.packed_shape(k, n)), dtype=store)
    nb, kb = bp.shape[1:3]
    sc = torch.ones((e, nb) if fmt.col_scaled else (e, nb, kb))
    out = torch.empty((e, s, c, n), dtype=BF16)
    cnt = torch.zeros(e, s, dtype=torch.int32) if counts else None
    return gg.launch_args(
        a, bp, n, cnt, b2_packed=torch.zeros_like(bp) if pair else None,
        bm=16, b_scales=sc, b2_scales=sc if pair else None, out=out,
        epilogue="silu_gate" if pair else "none", bias=None, fmt=fmt,
        stream=None)


@pytest.mark.parametrize("gran,mode", [("tile", 1), ("col", 2)])
@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("e,s,c,k,n", [(8, 1, 8, 6144, 16384),
                                       (8, 1, 8, 16384, 6144),
                                       (3, 2, 1, 700, 200),
                                       (2, 1, 16, 2048, 128)])
def test_k2_decode_splits_and_workspace(gran, mode, pair, e, s, c, k, n):
    """tc_stream_q: code 5; the split from E*S*Nb stripes and Kb only (the
    counts stay on the device), a workspace [splits, streams, E*S*C, N]
    when it splits."""
    fmt = _fmt("int8", gran, bk=128 if k % 128 == 0 else 64)
    args, keep, body = _k2_args(e, s, c, k, n, fmt, pair)
    kb, nb = -(-k // fmt.bk), -(-n // 64)
    splits, chunk = gt.tc_stream_split(kb, e * s * nb)
    assert body == "tc_stream_q" and args[K2_BODY_ARG] == 5
    assert args[K2_SCALE_MODE_ARG] == mode
    ws = keep[1]
    assert args[K2_SPLIT_ARGS][:2] == (splits, chunk)
    if splits > 1:
        assert tuple(ws.shape) == (splits, 2 if pair else 1, e * s * c, n)
    else:
        assert ws is None


@pytest.mark.parametrize("pair", [True, False])
def test_k2_prefill_takes_wgmma_q_unsplit(pair):
    args, keep, body = _k2_args(8, 1, 160, 6144, 2048, _fmt("int4", "col"),
                                pair)
    assert body == "wgmma_q" and args[K2_BODY_ARG] == 6
    assert args[K2_SPLIT_ARGS] == (1, 0, None) and keep[1] is None


@pytest.mark.parametrize("m,want", [(4, "tc_stream_q"), (40, "wgmma_q")])
def test_k1_launches_are_counted_by_body(monkeypatch, m, want):
    """Through a stubbed ``_kernel``: a launch adds one to ``launches`` and
    to ``variants[body]``; a failed launch raises and counts nothing."""
    fn, calls = gp.gemm_packed_fused_a, []

    def kernel(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 1
    monkeypatch.setattr(gp, "_kernel", lambda: kernel)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "variants", dict.fromkeys(gp.FUSED_BODIES, 0))
    fmt = _fmt("int8", "tile")
    k, n = 256, 128
    a = torch.zeros(m, k, dtype=BF16)
    bp = torch.zeros(fmt.packed_shape(k, n), dtype=I8)
    kw = dict(out_dtype=BF16, stream=None, bm=64, alpha=1.0, beta=0.0,
              b_scales=torch.ones(2, 2), epilogue="none", bias=None, fmt=fmt)
    assert tuple(gp._launch(a, bp, n, None, **kw).shape) == (m, n)
    assert fn.launches == 1 and fn.variants[want] == 1
    assert calls[0][K1_BODY_ARG] == gp._BODY_CODE[want]
    with pytest.raises(RuntimeError, match=want):
        gp._launch(a, bp, n, None, **kw)
    assert fn.launches == 1 and sum(fn.variants.values()) == 1


@pytest.mark.parametrize("name", ["gemm_grouped_packed_ragged",
                                  "gemm_grouped_packed"])
@pytest.mark.parametrize("c,want", [(8, "tc_stream_q"), (40, "wgmma_q")])
def test_k2_launches_are_counted_by_body(monkeypatch, name, c, want):
    fn, calls = getattr(gg, name), []

    def kernel(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 1
    monkeypatch.setattr(gg, "_kernel", lambda: kernel)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "variants", dict.fromkeys(gg.GROUPED_BODIES, 0))
    fmt = _fmt("int4", "col")
    e, k, n = 2, 256, 128
    a = torch.zeros(e, 1, c, k, dtype=BF16)
    bp = torch.zeros((e, *fmt.packed_shape(k, n)), dtype=I8)
    counts = (torch.zeros(e, 1, dtype=torch.int32)
              if name == "gemm_grouped_packed_ragged" else None)
    kw = dict(out_dtype=BF16, stream=None, b2_packed=bp, bm=16,
              b_scales=torch.ones(e, 2), b2_scales=torch.ones(e, 2),
              epilogue="silu_gate", bias=None, fmt=fmt)
    assert tuple(gg._launch(fn, a, bp, n, counts, **kw).shape) == (e, 1, c, n)
    assert fn.launches == 1 and fn.variants[want] == 1
    assert calls[0][K2_BODY_ARG] == gg._BODY_CODE[want]
    with pytest.raises(RuntimeError, match=want):
        gg._launch(fn, a, bp, n, counts, **kw)
    assert fn.launches == 1 and sum(fn.variants.values()) == 1


def test_wrappers_count_the_new_bodies():
    assert {"tc_stream_q", "wgmma_q"} <= set(gp.gemm_packed_fused_a.variants)
    for fn in (gg.gemm_grouped_packed_ragged, gg.gemm_grouped_packed):
        assert {"tc_stream_q", "wgmma_q"} <= set(fn.variants)


# -- a CPU model of gemm_quant.cuh's arithmetic ---------------------------------

def _half_bits(bits, dtype):
    """uint16 bit patterns -> float64 values of ``dtype`` (bf16 / f16)."""
    t = torch.from_numpy(np.asarray(bits, np.uint16).view(np.int16))
    return t.view(dtype)


def _widen_i8(vals, dtype):
    """QWiden::i8 on int8 values (as the source writes it), in the working
    type: bf16 128 + (v & 127) less 128 | 256, f16 1024 + (v ^ 128) less
    1152."""
    b = np.asarray(vals, np.int64) & 0xFF
    if dtype == BF16:
        r, s = (b & 0x7F) | 0x4300, (b & 0x80) | 0x4300
    else:
        r, s = (b ^ 0x80) | 0x6400, np.full_like(b, 0x6480)
    return (_half_bits(r, dtype) - _half_bits(s, dtype)).float()


def _widen_i4(vals, dtype):
    n = np.asarray(vals, np.int64) & 0xF
    base = 0x4308 if dtype == BF16 else 0x6408
    return (_half_bits(n ^ base, dtype)
            - _half_bits(np.full_like(n, base), dtype)).float()


@pytest.mark.parametrize("dtype", [BF16, F16])
def test_widening_is_exact_for_every_stored_value(dtype):
    """Every int8 value (-128 included) and every int4 nibble (-8 included)
    comes out exactly, in one packed subtraction in the working type."""
    v8, v4 = np.arange(-128, 128), np.arange(-8, 8)
    assert torch.equal(_widen_i8(v8, dtype), torch.from_numpy(v8).float())
    assert torch.equal(_widen_i4(v4, dtype), torch.from_numpy(v4).float())


@pytest.mark.parametrize("text", [
    "bsub((x & 0x007F007Fu) | 0x43004300u, (x & 0x00800080u) | 0x43004300u)",
    "bsub((y & 0x000F000Fu) ^ 0x43084308u, 0x43084308u)",
    "hsub((x & 0x00FF00FFu) ^ 0x64806480u, 0x64806480u)",
    "hsub((y & 0x000F000Fu) ^ 0x64086408u, 0x64086408u)",
    "NIB_LO = 0, NIB_HI = 4"])
def test_the_model_is_the_source(text):
    """The widening the model above checks is the one the source runs."""
    assert QUANT_SRC.count(text) == 1


def _swizzle(offset, w):
    """TMA's w-byte swizzle of a box offset (16-byte chunks XORed with
    address bits 7 and up): the CUTLASS Swizzle<log2(w/16), 4, 3>."""
    mask = w // 16 - 1
    return offset ^ (((offset >> 7) & mask) << 4)


def _qsw(r, b, w):
    """The source's qsw<w>(box, r, b) as a box offset."""
    return r * w + ((((b >> 4) ^ ((r * w) >> 7)) & (w // 16 - 1)) << 4) + (b & 15)


@pytest.mark.parametrize("w", [32, 64])
def test_qsw_is_tmas_swizzle(w):
    for r in range(64):
        for b in range(w):
            assert _qsw(r, b, w) == _swizzle(r * w + b, w)


def _qcol(q, col):
    return q if col else 2 * (q % 8) + q // 8


def _model_frags(box_bytes, i4, col, c, ks, lane):
    """quant_frags on a swizzled box (numpy uint8, 64 rows): per fragment
    f[0..3] the pair of stored values (low, high half) it widens."""
    w = 32 if i4 else 64
    g, k = lane >> 2, ks * 16 + 2 * (lane & 3)

    def ld8(r, b):
        return int(box_bytes[_qsw(r, b, w)])

    def ld16(r, b):
        return ld8(r, b) | (ld8(r, b + 1) << 8)

    def nib(x, shift):
        v = (x >> shift) & 0xF
        return v - 16 if v >= 8 else v

    def byte(x, at):
        v = (x >> (8 * at)) & 0xFF
        return v - 256 if v >= 128 else v
    f = [None] * 4
    if not col:
        if i4:
            b = c // 2 + g
            y0 = ld8(k, b) | (ld8(k + 1, b) << 16)
            y8 = ld8(k + 8, b) | (ld8(k + 9, b) << 16)
            for i, (y, sh) in enumerate(((y0, 0), (y8, 0), (y0, 4), (y8, 4))):
                f[i] = (nib(y, sh), nib(y, sh + 16))
        else:
            b = c + 2 * g
            x0 = ld16(k, b) | (ld16(k + 1, b) << 16)
            x8 = ld16(k + 8, b) | (ld16(k + 9, b) << 16)
            for i, x in enumerate((x0, x8, x0 >> 8, x8 >> 8)):
                f[i] = (byte(x, 0), byte(x, 2))
    else:
        for h in range(2):
            n = c + g + 8 * h
            for q in range(2):
                if i4:
                    x = ld8(n, (k + 8 * q) // 2)
                    f[2 * h + q] = (nib(x, 0), nib(x, 4))
                else:
                    x = ld16(n, k + 8 * q)
                    x = x | (x << 8)
                    f[2 * h + q] = (byte(x, 0), byte(x, 2))
    return f


@pytest.mark.parametrize("i4", [False, True])
@pytest.mark.parametrize("col", [False, True])
def test_fragments_read_each_stored_value_into_its_slot(i4, col):
    """For a random 64 x 64 block of a tile, laid out in shared memory as
    TMA stores it (swizzled), every lane's fragments of every k16 step hold
    the values of the mma slots they feed: f[0] / f[1] k 2t, 2t + 1 / 2t +
    8, 2t + 9 of column qcol(g), f[2] / f[3] of column qcol(g + 8) (+16 per
    warp); over the four warps each of the 4096 values is read once."""
    rng = np.random.default_rng(7 + 2 * i4 + col)
    lo, hi = (-8, 8) if i4 else (-128, 128)
    blk = rng.integers(lo, hi, (64, 64))            # [k, n]
    stored = blk.T if col else blk                  # rows of the stored tile
    if i4:
        packed = ((stored[:, 0::2] & 0xF) | ((stored[:, 1::2] & 0xF) << 4))
    else:
        packed = stored & 0xFF
    w = packed.shape[1]
    box = np.zeros(64 * w, np.uint8)
    for r in range(64):
        for b in range(w):
            box[_swizzle(r * w + b, w)] = packed[r, b]
    seen = np.zeros((64, 64), np.int64)
    for warp in range(4):
        for ks in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                f = _model_frags(box, i4, col, 16 * warp, ks, lane)
                for i, pair in enumerate(f):
                    n = 16 * warp + _qcol(g + 8 * (i // 2), col)
                    k = ks * 16 + 2 * t + 8 * (i % 2)
                    assert pair == (blk[k, n], blk[k + 1, n])
                    seen[k, n] += 1
                    seen[k + 1, n] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("col", [False, True])
def test_qcol_maps_a_warps_positions_onto_its_columns(col):
    assert sorted(_qcol(q, col) for q in range(16)) == list(range(16))


# -- chip_smoke's planted faults -------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quant_faults_edit_their_sources_exactly_once():
    """Each QUANT_FAULTS edit of chip_smoke.py matches its target source
    once, in a kernel that includes it, and every fault names the cases it
    reaches."""
    cs = _chip_smoke()
    assert len(cs.QUANT_FAULTS) == 6
    for name, kernel, target, edits, reaches in cs.QUANT_FAULTS:
        text = (build.CSRC / target).read_text()
        assert (build.CSRC / f"{kernel}.cu").exists()
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            assert old != new
        assert callable(reaches)


def test_quant_faults_reach_the_served_shapes(monkeypatch):
    """chip_smoke's ``kq_served`` (the quantized bodies at the served shapes,
    here cut to small widths on the CPU) gives every QUANT_FAULTS fault
    cases of the new bodies to fail, and the earlier bodies' cases to none:
    the faults are judged at the served shapes as well as at the edges."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "OLMO_SHAPES", {(256, 128): 4, (128, 256): None})
    monkeypatch.setattr(cs, "MIX_D", 256)
    monkeypatch.setattr(cs, "MIX_F", 384)
    monkeypatch.setattr(cs, "log", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    reach = {}
    cs.kq_served(torch, dict(gp=gp, gg=gg, ref=ref, tf=tile_format),
                 quiet=True, reach=reach)
    bodies = {r["body"] for r in reach.values()}
    assert bodies == {"tc_stream_q", "wgmma_q", "mma_quant", "mma_sync"}
    assert {r["kernel"] for r in reach.values()} == {"K1", "K2"}
    for name, _, _, _, reaches in cs.QUANT_FAULTS:
        hit = [r for r in reach.values() if reaches(r)]
        assert hit, name
        assert all(r["body"] in ("tc_stream_q", "wgmma_q") for r in hit), name


# -- on the card -------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.Generator(device="cuda").manual_seed(21)


def _close(got, want, rtol=2e-2, atol=1e-3):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _k1_operands(gen, m, k, n, qd, gran, layout, bk, full_range):
    """A as a view whose columns past K hold NaN; B packed from float
    weights (quantized) or, with ``full_range``, from int values over the
    whole int8 / int4 range (-128 / -8 included) with random scales."""
    fmt = _fmt(qd, gran, bk, 64, layout)
    if full_range:
        lo, hi = (-8, 8) if qd == "int4" else (-128, 128)
        q = torch.randint(lo, hi, (k, n), generator=gen, device="cuda",
                          dtype=I8)
        bp = ref.pack_b_ref(q, TileFormat(bk=bk, bn=64, layout=layout,
                                          dtype=qd))
        nb, kb = bp.shape[:2]
        shape = (nb,) if gran == "col" else (nb, kb)
        sc = (torch.rand(shape, generator=gen, device="cuda") * 1e-2 + 1e-3
              if gran else None)
    else:
        w = torch.randn((k, n), generator=gen, device="cuda") * 0.05
        out = ref.pack_b_ref(w, fmt)
        bp, sc = out if gran else (out, None)
    buf = torch.full((m, -(-k // 8) * 8 + 8), math.nan, device="cuda")
    buf[:, :k] = torch.randn((m, k), generator=gen, device="cuda")
    return buf.to(BF16)[:, :k], bp, sc, fmt


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 16, 17, 160, 512])
@pytest.mark.parametrize("qd,gran,layout", [
    ("int8", "tile", "row"), ("int8", "col", "col"), ("int4", "tile", "col"),
    ("int4", "col", "row"), ("int8", None, "row")])
@pytest.mark.parametrize("k,bk", [(700, 64), (2048, 128)])
def test_cuda_k1_quant_bodies_match_plain(m, qd, gran, layout, k, bk):
    """Both K1 bodies against the plain version (bf16 output: rtol 2e-2 for
    the final rounding, f32 sums in other orders), K 700 (a tail box of
    padding) split and unsplit, every value of the range, gelu + bias, each
    call on the body fused_a_body names."""
    gen = _cuda()
    n = 200
    a, bp, sc, fmt = _k1_operands(gen, m, k, n, qd, gran, layout, bk, True)
    bias = torch.randn(n, generator=gen, device="cuda")
    fn = gp.gemm_packed_fused_a
    before = dict(fn.variants)
    got = fn(a, bp, n, b_scales=sc, b_format=fmt, epilogue="gelu", bias=bias)
    torch.cuda.synchronize()
    ran = [v for v, c in fn.variants.items() if c != before[v]]
    assert ran == ["tc_stream_q" if m <= 16 else "wgmma_q"]
    _close(got, gp.gemm_packed_fused_a_plain(a, bp, n, b_scales=sc,
                                             b_format=fmt, epilogue="gelu",
                                             bias=bias))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("epi", ["none", "relu", "silu", "tanh"])
def test_cuda_k1_quant_epilogues_with_c(m, epi):
    gen = _cuda()
    k, n = 2048, 2048
    a, bp, sc, fmt = _k1_operands(gen, m, k, n, "int8", "col", "row", 128,
                                  False)
    c = torch.randn((m, n), generator=gen, device="cuda")
    bias = torch.randn(n, generator=gen, device="cuda")
    kw = dict(b_scales=sc, b_format=fmt, epilogue=epi, bias=bias, c=c,
              alpha=1.5, beta=0.5)
    got = gp.gemm_packed_fused_a(a, bp, n, **kw)
    torch.cuda.synchronize()
    _close(got, gp.gemm_packed_fused_a_plain(a, bp, n, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gran", [("bfloat16", None), ("int4", "col")])
def test_cuda_kernel_matches_plain_version(dtype, gran):
    """A JAX-free copy of test_torch_gemm_packed.py's card test: K1 against
    its plain version (bf16 output: rtol 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((37, 300)).astype(np.float32)
    w = rng.standard_normal((300, 200)).astype(np.float32)
    scale = dict(scale=ScaleSpec(granularity=gran)) if gran else {}
    fmt = TileFormat(64, 64, dtype=dtype, **scale)
    wt = torch.from_numpy(w).cuda()
    out = ref.pack_b_ref(wt if gran else wt.to(BF16), fmt)
    bp, s = out if gran else (out, None)
    at = torch.from_numpy(a).cuda().to(BF16)
    got = gp.gemm_packed_fused_a(at, bp, 200, b_scales=s, b_format=fmt,
                                 bm=48, epilogue="gelu")
    want = gp.gemm_packed_fused_a_plain(at, bp, 200, b_scales=s,
                                        b_format=fmt, bm=48, epilogue="gelu")
    torch.cuda.synchronize()
    _close(got, want)


def _k2_stacks(gen, e, k, n, qd, gran, layout, bk, full_range):
    fmt = _fmt(qd, gran, bk, 64, layout)
    if full_range:
        lo, hi = (-8, 8) if qd == "int4" else (-128, 128)
        q = torch.randint(lo, hi, (e, k, n), generator=gen, device="cuda",
                          dtype=I8)
        bp = ref.pack_b_grouped_ref(q, TileFormat(bk=bk, bn=64, layout=layout,
                                                  dtype=qd))
        nb, kb = bp.shape[1:3]
        shape = (e, nb) if gran == "col" else (e, nb, kb)
        return bp, (torch.rand(shape, generator=gen, device="cuda") * 1e-2
                    + 1e-3 if gran else None), fmt
    w = torch.randn((e, k, n), generator=gen, device="cuda") * 0.05
    out = ref.pack_b_grouped_ref(w, fmt)
    return (*(out if gran else (out, None)), fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 16, 17, 160, 300])
@pytest.mark.parametrize("qd,gran,layout", [
    ("int8", "tile", "row"), ("int4", "col", "col"), ("int8", "col", "col"),
    ("int4", "tile", "row")])
@pytest.mark.parametrize("pair", [True, False])
def test_cuda_k2_quant_bodies_match_plain(c, qd, gran, layout, pair):
    """Both K2 bodies against the plain version: counts 0, partial, C, > C
    and negative; K 700 (bk 64); the pair with B != B2 (their own scales)
    or gelu + bias; rows past the counts exactly 0; each call on the body
    grouped_body names."""
    gen = _cuda()
    e, s, k, n = 3, 2, 700, 200
    bp, sc, fmt = _k2_stacks(gen, e, k, n, qd, gran, layout, 64, True)
    b2p, sc2, _ = (_k2_stacks(gen, e, k, n, qd, gran, layout, 64, True)
                   if pair else (None, None, None))
    # Rows of a buffer 704 wide (a row stride of 16 bytes' multiple).
    a = torch.randn((e, s, c, 704), generator=gen,
                    device="cuda").to(BF16)[..., :k]
    counts = torch.tensor([[0, c], [c // 2, 1], [c + 7, -2]],
                          dtype=torch.int32, device="cuda")
    kw = dict(b2_packed=b2p, b_scales=sc, b2_scales=sc2, b_format=fmt,
              epilogue="silu_gate" if pair else "gelu",
              bias=None if pair else torch.randn((e, n), generator=gen,
                                                 device="cuda"))
    fn = gg.gemm_grouped_packed_ragged
    before = dict(fn.variants)
    got = fn(a, bp, n, counts, **kw)
    torch.cuda.synchronize()
    ran = [v for v, x in fn.variants.items() if x != before[v]]
    assert ran == ["tc_stream_q" if c <= 16 else "wgmma_q"]
    _close(got, gg.gemm_grouped_packed_ragged_plain(a, bp, n, counts, **kw))
    mask = ref.ragged_row_mask(c, counts.clamp(0, c))
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 160])
def test_cuda_k3_quant_pair_matches_plain(c):
    """K3 (every row live) on the new bodies: the int8 tile-scaled pair at
    K 2048 (tiles of 128, split at decode)."""
    gen = _cuda()
    e, k, n = 4, 2048, 256
    bp, sc, fmt = _k2_stacks(gen, e, k, n, "int8", "tile", "row", 128, False)
    b2p, sc2, _ = _k2_stacks(gen, e, k, n, "int8", "tile", "row", 128, False)
    a = torch.randn((e, c, k), generator=gen, device="cuda").to(BF16)
    kw = dict(b2_packed=b2p, b_scales=sc, b2_scales=sc2, b_format=fmt,
              epilogue="silu_gate")
    got = gg.gemm_grouped_packed(a, bp, n, **kw)
    torch.cuda.synchronize()
    _close(got, gg.gemm_grouped_packed_plain(a, bp, n, **kw))


def _moe_cuda_case(seed, e, s, c, k, n, dtype, gran, layout, gate):
    """The operands of test_torch_moe.py's card tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = dict(scale=ScaleSpec(granularity=gran)) if gran else {}
    fmt = TileFormat(64, 64, layout, dtype, **scale)

    def stack():
        w = torch.randn((e, k, n), generator=gen, device="cuda") * 0.05
        out = ref.pack_b_grouped_ref(w if gran else w.to(BF16), fmt)
        return out if gran else (out, None)

    (bp, sc), (b2p, sc2) = stack(), (stack() if gate else (None, None))
    a = torch.randn((e, s, c, k), generator=gen, device="cuda").to(BF16)
    kw = dict(b2_packed=b2p, b_scales=sc, b2_scales=sc2, b_format=fmt,
              epilogue="silu_gate" if gate else "gelu",
              bias=None if gate else torch.randn((e, n), generator=gen,
                                                 device="cuda"))
    return a, bp, kw


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 70])
@pytest.mark.parametrize("dtype,gran,layout,gate", [
    ("bfloat16", None, "row", True), ("int8", "tile", "col", False),
    ("int4", "col", "row", True)])
def test_cuda_k2_matches_plain_version(c, dtype, gran, layout, gate):
    """A JAX-free copy of test_torch_moe.py's K2 card test (bf16 output:
    rtol 2e-2); rows past the counts exactly 0."""
    e, s, k, n = 3, 2, 200, 192
    a, bp, kw = _moe_cuda_case(0, e, s, c, k, n, dtype, gran, layout, gate)
    counts = torch.tensor([[0, c], [c // 2, 1], [c + 9, -1]],
                          dtype=torch.int32, device="cuda")
    got = gg.gemm_grouped_packed_ragged(a, bp, n, counts, **kw)
    want = gg.gemm_grouped_packed_ragged_plain(a, bp, n, counts, **kw)
    torch.cuda.synchronize()
    _close(got, want)
    mask = ref.ragged_row_mask(c, counts.clamp(0, c))
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gran,layout,gate", [
    ("bfloat16", None, "col", False), ("int8", "col", "row", True)])
def test_cuda_k3_matches_plain_version(dtype, gran, layout, gate):
    """A JAX-free copy of test_torch_moe.py's K3 card test."""
    e, m, k, n = 3, 40, 200, 192
    a, bp, kw = _moe_cuda_case(1, e, 1, m, k, n, dtype, gran, layout, gate)
    got = gg.gemm_grouped_packed(a[:, 0], bp, n, **kw)
    want = gg.gemm_grouped_packed_plain(a[:, 0], bp, n, **kw)
    torch.cuda.synchronize()
    _close(got, want)


def test_no_jax_here():
    """The card's machine has no JAX: this file must not need it."""
    src = Path(__file__).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src, re.M)
