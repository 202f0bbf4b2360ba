"""Launch geometry of K5 (``pack_a`` / ``pack_b`` / ``pack_b_grouped``): the
pure-Python route (``pack_body``, after ``pack_tma_aligned`` / ``pack_plan``
over the strides ``pack_strides`` gives), a Python model of the TMA
bodies' persistent walk (boxes loaded, offsets stored) and of the stage
pass's diagonal transpose, the launch counts by body (pinned on CPU
tensors through a stubbed ``_kernel``, no launch), and the planted faults
of ``chip_smoke.py`` against ``pack.cu``; and, on a card (``cuda``
marker), each body byte for byte against the plain packers at its edges.
The file imports no JAX: ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_pack_geometry.py`` runs on the card."""
import re
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch.core import tile_format as tf
from repro_torch.core.tile_format import cdiv, pack_nibbles
from repro_torch.kernels import build
from repro_torch.kernels import pack as pk

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (the K5 cases and faults of the chip run)

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
SOURCE = (build.CSRC / "pack.cu").read_text()

# The C entry point's argument positions (pack.py _ARGTYPES).
STRIDES_ARG, BODY_ARG = slice(5, 8), 13


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _case_input(i, device="cpu"):
    """Case i of chip_smoke's K5_CASES: (X, wrapper name, its arguments,
    the body it must take)."""
    fn, dtype, gran, layout, shape, view, tile, want = cs.K5_CASES[i]
    gen = torch.Generator(device=device).manual_seed(i)
    x = cs.k5_input(torch, gen, device, dtype, gran, shape, view)
    _, _, args = cs.k5_call(pk, tf, fn, dtype, gran, layout, tile)
    return x, fn, args, want


# -- the route ----------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(cs.K5_CASES)))
def test_every_phase1_case_takes_the_body_it_names(i):
    """Every K5 case of chip_smoke's phase 1 routes, through pack_body on X
    as the kernel sees it, to the body the case table names."""
    x, fn, args, want = _case_input(i)
    assert pk.pack_body(*cs.k5_launched(pk, fn, x, args)) == want


def test_the_cases_reach_every_body_and_every_fault():
    bodies = Counter(case[-1] for case in cs.K5_CASES)
    assert set(bodies) == set(pk.PACK_BODIES) and min(bodies.values()) >= 15
    reach = [cs.k5_reach(pk, *cs.k5_launched(pk, fn, x, args))
             for x, fn, args, _ in (_case_input(i) for i in range(len(cs.K5_CASES)))]
    for name, _, reaches in cs.K5_FAULTS:
        assert sum(map(reaches, reach)) >= 10, name


@pytest.mark.parametrize("x,b0,b1,transpose,want", [
    # olmo-1b's per-call packs and the load's: row-major bf16, bk 128 bn 64
    (_meta(1, 2048, 2048), 128, 64, False,
     pk.PackPlan("c", False, 128, 1, (64, 128), 16384)),
    (_meta(1, 2048, 8192), 128, 64, False,
     pk.PackPlan("c", False, 128, 1, (64, 128), 16384)),
    (_meta(1, 8192, 2048), 128, 64, False,
     pk.PackPlan("c", False, 128, 1, (64, 128), 16384)),
    # the LM head at load: table.t(), R-contiguous, transposed by the pass
    (_meta(50304, 2048).t()[None], 128, 64, False,
     pk.PackPlan("r", True, 128, 1, (128, 64), 16384)),
    (_meta(32768, 6144).t()[None], 128, 64, False,
     pk.PackPlan("r", True, 128, 1, (128, 64), 16384)),
    # mixtral's expert stacks and attention projections at load
    (_meta(8, 6144, 16384), 128, 64, False,
     pk.PackPlan("c", False, 128, 1, (64, 128), 16384)),
    (_meta(8, 16384, 6144), 128, 64, False,
     pk.PackPlan("c", False, 128, 1, (64, 128), 16384)),
    (_meta(1, 6144, 1024), 128, 64, False,
     pk.PackPlan("c", False, 128, 1, (64, 128), 16384)),
    # the col layout of a row-major X: 64 stored rows of 128
    (_meta(1, 2048, 2048), 128, 64, True,
     pk.PackPlan("c", True, 64, 1, (64, 128), 16384)),
    # a 64 KB tile: four 16 KB slabs of 64 stored rows
    (_meta(1, 2048, 2048), 256, 128, False,
     pk.PackPlan("c", False, 64, 4, (128, 64), 16384)),
    # f32 transposed 256 x 128: eight slabs of 16 rows along u
    (_meta(1, 2048, 2048, dtype=F32), 256, 128, True,
     pk.PackPlan("c", True, 16, 8, (16, 256), 16384)),
])
def test_plans_at_the_served_shapes(x, b0, b1, transpose, want):
    assert pk.pack_plan(x, b0, b1, transpose, False) == want
    assert pk.pack_tma_aligned(x, b0, b1, transpose, False)
    copy = want.transpose_pass is False
    assert pk.pack_body(x, b0, b1, transpose, False) == (
        "tma_copy" if copy else "tma_stage")


@pytest.mark.parametrize("x,b0,b1,transpose,nibble,want", [
    (_meta(1, 2048, 2048), 128, 64, False, False, "tma_copy"),
    (_meta(2048, 2048).t()[None], 128, 64, True, False, "tma_copy"),
    (_meta(2048, 2048).t()[None], 128, 64, False, False, "tma_stage"),
    (_meta(1, 2048, 2048), 128, 64, True, False, "tma_stage"),
    (_meta(1, 2048, 2048, dtype=I8), 128, 64, False, True, "tma_stage"),
    (_meta(1, 2048, 2048, dtype=I8), 128, 64, True, True, "tma_stage"),
    (_meta(1, 2048, 2048, dtype=I8), 128, 64, False, False, "tma_copy"),
    # 8-byte elements, tiles over 256
    (_meta(1, 2048, 2048, dtype=torch.float64), 128, 64, False, False, "general"),
    (_meta(1, 2048, 2048, dtype=torch.int64), 128, 64, True, False, "general"),
    (_meta(1, 2048, 2048), 512, 64, False, False, "general"),
    (_meta(1, 2048, 2048), 128, 512, False, False, "general"),
    # no unit stride, a stride off 16 bytes, overlapping rows
    (_meta(1, 2048, 4096)[:, :, ::2], 128, 64, False, False, "general"),
    (_meta(1, 37, 70), 64, 32, False, False, "general"),
    (torch.empty(2048, dtype=BF16, device="meta").as_strided((1, 64, 64), (4096, 32, 1)),
     16, 16, False, False, "general"),
    # a transposed tile whose v extent is no whole 32-bit lane
    (_meta(1, 64, 64, dtype=I8), 6, 16, True, False, "general"),
    (_meta(1, 64, 64), 5, 16, True, False, "general"),
    (_meta(1, 64, 64, dtype=F32), 5, 16, True, False, "tma_stage"),
    # a box whose contiguous extent is off 16 bytes
    (_meta(1, 64, 64), 16, 4, False, False, "general"),
])
def test_pack_body_follows_the_route_table(x, b0, b1, transpose, nibble, want):
    assert pk.pack_body(x, b0, b1, transpose, nibble) == want
    assert pk.pack_tma_aligned(x, b0, b1, transpose, nibble) == (want != "general")


def test_a_base_off_16_bytes_takes_general():
    """An odd element offset (on the CPU, as on the card, an allocation is
    16-byte aligned) moves the base off 16 bytes."""
    buf = torch.zeros(300 * 200 + 8, dtype=BF16)
    assert pk.pack_body(buf[:-8].view(1, 300, 200), 64, 32, False, False) == "tma_copy"
    for off in (1, 3, 7):
        x = buf[off:off + 300 * 200].view(1, 300, 200)
        assert pk.pack_body(x, 64, 32, False, False) == "general"
    assert pk.pack_body(buf[8:].view(1, 300, 200), 64, 32, False, False) == "tma_copy"


@pytest.mark.parametrize("x,want", [
    # a [K, 1] column: R-contiguous when its row stride is 1
    (_meta(1, 300, 1), (304, 1, 304)),
    (_meta(1, 300, 3)[:, :, :1], (900, 3, 1)),
    # a [1, N] row: C-contiguous, its row stride N rounded up to 16 bytes
    (_meta(1, 1, 200), (200, 200, 1)),
    (_meta(1, 1, 201), (208, 208, 1)),
    (_meta(1, 200, 1).transpose(1, 2), (200, 200, 1)),
    # 1 x 1: C-contiguous, one 16-byte row
    (_meta(1, 1, 1), (8, 8, 1)),
    (_meta(1, 1, 1, dtype=F32), (4, 4, 1)),
    # E = 1 steps by the matrix's span; E > 1 keeps its stride
    (_meta(300, 200).t()[None], (60000, 1, 200)),
    (_meta(3, 300, 200), (60000, 200, 1)),
    (_meta(3, 200, 300).transpose(1, 2), (60000, 1, 300)),
])
def test_pack_strides_free_the_strides_of_extent_one_dims(x, want):
    assert pk.pack_strides(x) == want


@pytest.mark.parametrize("x,transpose,want", [
    (_meta(1, 1, 2048), False, "tma_copy"),      # K = 1
    (_meta(1, 2048, 1), False, "tma_stage"),     # N = 1, R-contiguous
    (_meta(1, 2048, 1), True, "tma_copy"),
    (_meta(1, 2048, 8)[:, :, :1], False, "tma_copy"),  # N = 1 of a wider matrix
    (_meta(2048, 1).t()[None], False, "tma_copy"),     # a [1, N] view of a column
    (_meta(1, 1, 1), False, "tma_copy"),
])
def test_extent_one_dims_keep_their_layout(x, transpose, want):
    """K = 1, N = 1 (a column, of a matrix or of a wider one), a row view of
    a column and 1 x 1 take the body of the layout they have."""
    assert pk.pack_body(x, 128, 64, transpose, False) == want


# -- the persistent walk (pack.cu load_chunk / my_chunks), modelled ------------

def walk(x3, b0, b1, *, col_order, transpose, nibble, grid):
    """The TMA bodies' walk, as pack.cu makes it: block b of ``grid`` takes
    chunks b, b + grid, ... in output order; chunk c is slab c % q of tile
    c // q (tiles in output order). Yields (block, chunk, the box origin
    (along u, along v, e), the output byte offset)."""
    plan = pk.pack_plan(x3, b0, b1, transpose, nibble)
    e, r, c = x3.shape
    gr, gc = cdiv(r, b0), cdiv(c, b1)
    n_outer, n_inner = (gc, gr) if col_order else (gr, gc)
    bu, bv = (b1, b0) if plan.unit == "c" else (b0, b1)
    chunks = e * gr * gc * plan.chunks
    for b in range(min(grid, chunks)):
        for ch in range(b, chunks, grid):
            t, sub = divmod(ch, plan.chunks)
            rest, gi = divmod(t, n_inner)
            ee, go = divmod(rest, n_outer)
            g0, g1 = (gi, go) if col_order else (go, gi)
            gu, gv = (g1, g0) if plan.unit == "c" else (g0, g1)
            cu = gu * bu + (sub * plan.chunk_rows if plan.transpose_pass else 0)
            cv = gv * bv + (0 if plan.transpose_pass else sub * plan.chunk_rows)
            yield b, ch, (cu, cv, ee), ch * plan.chunk_bytes


def run_walk(x3, b0, b1, *, col_order, transpose, nibble, grid):
    """The walk run with torch indexing: each box cut from a zero-padded
    copy of X laid out [E, v, u], transposed when the plan says so,
    nibble-packed along its trailing axis when asked, and stored at its
    offset. Returns (the output bytes, how often each byte was written)."""
    plan = pk.pack_plan(x3, b0, b1, transpose, nibble)
    xvu = x3 if plan.unit == "c" else x3.transpose(1, 2)
    (bu, bv), (box_u, box_v) = ((b1, b0) if plan.unit == "c" else (b0, b1)), plan.box
    padded = torch.zeros((xvu.shape[0], cdiv(xvu.shape[1], bv) * bv,
                          cdiv(xvu.shape[2], bu) * bu), dtype=x3.dtype)
    padded[:, :xvu.shape[1], :xvu.shape[2]] = xvu
    e, r, c = x3.shape
    total = e * cdiv(r, b0) * cdiv(c, b1) * plan.chunks * plan.chunk_bytes
    out = torch.zeros(total, dtype=torch.uint8)
    writes = torch.zeros(total, dtype=torch.int32)
    for _, _, (cu, cv, ee), off in walk(x3, b0, b1, col_order=col_order,
                                        transpose=transpose, nibble=nibble, grid=grid):
        box = padded[ee, cv:cv + box_v, cu:cu + box_u]
        slab = box.t() if plan.transpose_pass else box
        if nibble:
            slab = pack_nibbles(slab)
        data = slab.contiguous().view(torch.uint8).flatten()
        assert data.numel() == plan.chunk_bytes
        out[off:off + plan.chunk_bytes] = data
        writes[off:off + plan.chunk_bytes] += 1
    return out, writes


def plain_bytes(x3, b0, b1, *, col_order, transpose, nibble):
    layout = "col" if transpose else "row"
    if col_order:
        want = pk.pack_b_grouped_plain(x3, b0, b1, layout)
    else:
        want = torch.stack([pk.pack_a_plain(x, b0, b1, layout) for x in x3])
    if nibble:
        want = pack_nibbles(want)
    return want.contiguous().view(torch.uint8).flatten()


def _x(shape, dtype, view):
    """X [E, R, C] laid out as chip_smoke's K5 cases lay it out."""
    return cs.k5_input(torch, torch.Generator().manual_seed(0), "cpu", dtype, None,
                       shape, view)


@pytest.mark.parametrize("shape,dtype,view,b0,b1,col_order,transpose,nibble,grid", [
    ((1, 300, 200), "bfloat16", "contig", 64, 32, True, False, False, 7),
    ((3, 300, 200), "bfloat16", "padded", 64, 32, True, False, False, 264),
    ((3, 300, 200), "bfloat16", "padded", 64, 32, False, False, False, 5),
    ((2, 300, 200), "bfloat16", "padded", 64, 32, True, True, False, 3),
    ((2, 300, 200), "bfloat16", "padded", 64, 32, False, True, False, 1),
    ((2, 300, 200), "bfloat16", "t_padded", 128, 64, True, False, False, 11),
    ((2, 300, 200), "bfloat16", "t_padded", 64, 32, True, True, False, 2),
    ((1, 600, 300), "bfloat16", "padded", 256, 128, True, False, False, 13),
    ((1, 600, 300), "float32", "padded", 256, 128, True, True, False, 9),
    ((2, 300, 200), "float32", "t_padded", 64, 32, False, False, False, 4),
    ((2, 100, 96), "float32", "contig", 16, 16, True, True, False, 3),
    ((3, 320, 224), "int8", "contig", 64, 32, True, False, True, 6),
    ((3, 320, 224), "int8", "contig", 64, 32, True, True, True, 6),
    ((2, 300, 200), "int8", "padded", 64, 32, True, True, False, 5),
    ((1, 300, 1), "bfloat16", "contig", 64, 32, True, False, False, 2),
    ((1, 1, 200), "bfloat16", "contig", 64, 32, True, False, False, 2),
])
def test_the_walk_stores_every_chunk_once_and_equals_the_plain_packers(
        shape, dtype, view, b0, b1, col_order, transpose, nibble, grid):
    """E, R and C off whole tiles (where the case has them), row order
    (pack_a) and col order (pack_b): every output byte is stored exactly
    once, and the boxes, cut from a zero-padded copy, transformed and
    stored where the walk says, give the plain packers' bytes."""
    x3 = _x(shape, dtype, view)
    kw = dict(col_order=col_order, transpose=transpose, nibble=nibble)
    assert pk.pack_plan(x3, b0, b1, transpose, nibble) is not None
    out, writes = run_walk(x3, b0, b1, grid=grid, **kw)
    assert bool((writes == 1).all())
    assert torch.equal(out, plain_bytes(x3, b0, b1, **kw))


@pytest.mark.parametrize("grid", [1, 2, 5, 264])
def test_each_block_walks_its_share_in_output_order(grid):
    """Block b walks chunks b, b + grid, ... (my_chunks of them), so that
    neighbouring blocks store neighbouring chunks at once."""
    x3 = _x((2, 300, 200), "bfloat16", "padded")
    seen = list(walk(x3, 64, 32, col_order=True, transpose=False, nibble=False, grid=grid))
    chunks = len(seen)
    for b in range(min(grid, chunks)):
        mine = [ch for blk, ch, _, _ in seen if blk == b]
        assert mine == list(range(b, chunks, grid))
        assert len(mine) == (chunks - b + grid - 1) // grid   # my_chunks


# -- the stage pass's transpose (pack.cu stage_pass), modelled -----------------

@pytest.mark.parametrize("eb,box_u,box_v", [
    (2, 64, 128), (2, 128, 64), (2, 8, 48), (1, 64, 128), (1, 16, 64),
    (1, 256, 32), (4, 32, 64), (4, 16, 256), (4, 4, 6)])
def test_the_diagonal_transpose_moves_each_block_once_without_bank_conflicts(
        eb, box_u, box_v):
    """Pass k of a 32 x 32 square of P x P blocks: lane l moves block (row
    l, column (l + k) % 32). Each block of the box moves exactly once, and
    each of a warp's P reads and P writes meets 32 distinct banks (even
    box sides)."""
    p = 4 // eb
    ub, vb = box_u // p, box_v // p
    squares_u = cdiv(ub, 32)
    moved = Counter()
    for it in range(squares_u * cdiv(vb, 32) * 32):
        sq, k = divmod(it, 32)
        lanes = [((sq // squares_u) * 32 + lane, (sq % squares_u) * 32 + (lane + k) % 32)
                 for lane in range(32)]
        lanes = [(jb, ib) for jb, ib in lanes if jb < vb and ib < ub]
        moved.update(lanes)
        for r in range(p):
            reads = [((p * jb + r) * ub + ib) % 32 for jb, ib in lanes]
            writes = [((p * ib + r) * vb + jb) % 32 for jb, ib in lanes]
            assert len(set(reads)) == len(reads) and len(set(writes)) == len(writes)
    assert moved == Counter({(jb, ib): 1 for jb in range(vb) for ib in range(ub)})


# -- launches by body, through a stubbed kernel --------------------------------

@pytest.mark.parametrize("x3,b0,b1,transpose,nibble,want", [
    (torch.zeros(1, 300, 200, dtype=BF16), 64, 32, False, False, "tma_copy"),
    (torch.zeros(1, 200, 320, dtype=BF16)[:, :, :300].transpose(1, 2), 128, 64, False,
     False, "tma_stage"),
    (torch.zeros(2, 320, 224, dtype=I8), 64, 32, False, True, "tma_stage"),
    (torch.zeros(1, 300, 200, dtype=torch.float64), 64, 32, True, False, "general"),
    (torch.zeros(1, 300, 200, dtype=BF16)[:, :, 1:], 64, 32, False, False, "general"),
])
def test_launches_are_counted_by_body(monkeypatch, x3, b0, b1, transpose, nibble, want):
    """Through a stubbed ``_kernel``: one launch adds one to ``launches`` and
    to ``variants[body]``, the body whose code the C entry point was handed
    with the strides ``pack_strides`` gives; a failed launch raises, names
    its body and counts nothing."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 1
    monkeypatch.setattr(pk, "_kernel", lambda: kernel)
    monkeypatch.setattr(pk.pack_b, "launches", 0)
    monkeypatch.setattr(pk.pack_b, "variants", dict.fromkeys(pk.PACK_BODIES, 0))
    kw = dict(col_order=True, transpose=transpose, nibble=nibble, wrapper=pk.pack_b)
    out = pk._launch(x3, b0, b1, **kw)
    t0, t1 = (b1, b0) if transpose else (b0, b1)
    assert tuple(out.shape) == (x3.shape[0], cdiv(x3.shape[2], b1), cdiv(x3.shape[1], b0),
                                t0, t1 // 2 if nibble else t1)
    assert pk.pack_b.launches == 1 and pk.pack_b.variants[want] == 1
    assert sum(pk.pack_b.variants.values()) == 1
    assert calls[0][BODY_ARG] == pk.BODY_CODES[want]
    assert calls[0][STRIDES_ARG] == pk.pack_strides(x3)
    assert len(calls[0]) == len(pk._ARGTYPES)
    with pytest.raises(RuntimeError, match=want):
        pk._launch(x3, b0, b1, **kw)
    assert pk.pack_b.launches == 1 and sum(pk.pack_b.variants.values()) == 1


def test_empty_outputs_and_cpu_tensors_launch_nothing(monkeypatch):
    monkeypatch.setattr(pk, "_kernel", lambda: pytest.fail("launched"))
    monkeypatch.setattr(pk.pack_b, "launches", 0)
    for x3 in (torch.zeros(1, 0, 200, dtype=BF16), torch.zeros(0, 300, 200, dtype=BF16)):
        out = pk._launch(x3, 64, 32, col_order=True, transpose=False, nibble=False,
                         wrapper=pk.pack_b)
        assert out.numel() == 0
    pk.pack_b(torch.zeros(300, 200, dtype=BF16), 64, 32)
    pk.pack_a(torch.zeros(300, 200, dtype=BF16), 64, 32)
    pk.pack_b_grouped(torch.zeros(2, 300, 200, dtype=BF16), 64, 32)
    assert pk.pack_b.launches == 0


def test_nibble_packing_refuses_what_it_cannot_pack():
    with pytest.raises(ValueError, match="nibble"):
        pk._launch(torch.zeros(1, 64, 64, dtype=BF16), 16, 16, col_order=True,
                   transpose=False, nibble=True, wrapper=pk.pack_b)
    with pytest.raises(ValueError, match="nibble"):
        pk._launch(torch.zeros(1, 64, 64, dtype=I8), 16, 15, col_order=True,
                   transpose=False, nibble=True, wrapper=pk.pack_b)


def test_every_wrapper_counts_every_body():
    for fn in (pk.pack_a, pk.pack_b, pk.pack_b_grouped):
        assert set(fn.variants) == set(pk.PACK_BODIES)
    assert len(pk.PACK_BODIES) == 3


def test_counters_reset_zeroes_k5_bodies():
    counters = cs.Counters([pk.pack_b, pk.pack_b_grouped])
    saved = [(fn.launches, dict(fn.variants)) for fn in (pk.pack_b, pk.pack_b_grouped)]
    try:
        pk.pack_b.launches, pk.pack_b.variants["tma_stage"] = 3, 2
        pk.pack_b_grouped.variants["tma_copy"] = 5
        counters.reset()
        assert counters.read() == {"pack_b": 0, "pack_b_grouped": 0}
        assert counters.variants() == {name: dict.fromkeys(pk.PACK_BODIES, 0)
                                       for name in ("pack_b", "pack_b_grouped")}
    finally:
        for fn, (n, v) in zip((pk.pack_b, pk.pack_b_grouped), saved):
            fn.launches = n
            fn.variants.update(v)


# -- the CUDA source against the Python route ----------------------------------

def test_the_source_and_the_route_share_their_constants():
    """The body codes, the box limit and the stage size of pack.cu are the
    ones pack.py routes by, and the C entry takes as many arguments as
    ``_ARGTYPES`` binds."""
    enum = re.search(r"enum Body \{([^}]*)\}", SOURCE).group(1)
    codes = {name.strip().lower(): int(v) for name, v in
             (item.split("=") for item in enum.split(","))}
    assert codes == pk.BODY_CODES
    assert f"constexpr int TMA_BOX_MAX = {pk.TMA_BOX_MAX};" in SOURCE
    assert f"constexpr int CHUNK_BYTES = {pk.CHUNK_BYTES};" in SOURCE
    params = re.search(r'extern "C" int pack_tiles_launch\(([^)]*)\)', SOURCE).group(1)
    assert len(params.split(",")) == len(pk._ARGTYPES)


@pytest.mark.parametrize("i", range(3))
def test_k5_faults_edit_pack_cu_exactly_once(i):
    """``chip_smoke.py --planted-faults`` applies each fault's edits to a
    copy of pack.cu: every edited text must sit in it exactly once, so that
    a fault cannot silently miss."""
    assert len(cs.K5_FAULTS) == 3
    name, edits, _ = cs.K5_FAULTS[i]
    text = SOURCE
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        assert old != new
        text = text.replace(old, new)


# -- on the card: each body against the plain packers, byte for byte ---------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _byte_equal_under_poison(fn, plain, x, args, want_body):
    """The kernel against the plain packer on the body it must take; a
    freed block of the output's size filled with 0xFF lies where the
    output is allocated, so a chunk the kernel does not store shows."""
    want = plain(x, *args)
    want_t = want if isinstance(want, tuple) else (want,)
    poison = torch.full((want_t[0].numel() * want_t[0].element_size(),), 0xFF,
                        dtype=torch.uint8, device="cuda")
    del poison
    before = dict(fn.variants)
    got = fn(x, *args)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    assert [v for v, c in fn.variants.items() if c != before[v]] == [want_body]
    for g, w in zip(got_t, want_t, strict=True):
        assert cs.same_bytes(torch, g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(cs.K5_CASES)))
def test_cuda_every_phase1_case_byte_equal_on_its_body(i):
    _cuda()
    x, fn_name, args, want = _case_input(i, "cuda")
    fn, plain, _ = cs.k5_call(pk, tf, fn_name, *cs.K5_CASES[i][1:4], cs.K5_CASES[i][6])
    _byte_equal_under_poison(fn, plain, x, args, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,view,want", [
    ((2048, 8192), "contig", "tma_copy"),
    ((8192, 2048), "contig", "tma_copy"),
    ((2048, 50304), "t", "tma_stage"),
    ((4, 2048, 8192), "contig", "tma_copy"),
])
def test_cuda_served_shapes_byte_equal(shape, view, want):
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = cs.k5_input(torch, gen, "cuda", "bfloat16", None, shape, view)
    fmt = tf.TileFormat(bk=128, bn=64, dtype="bfloat16")
    fn, plain = ((pk.pack_b, pk.pack_b_plain) if len(shape) == 2
                 else (pk.pack_b_grouped, pk.pack_b_grouped_plain))
    _byte_equal_under_poison(fn, plain, x, (fmt,), want)


@pytest.mark.cuda
@pytest.mark.parametrize("view,transpose", [("contig", False), ("t", False),
                                            ("contig", True)])
def test_cuda_general_body_on_tma_shapes(view, transpose):
    """The general body, called through the C entry where the route would
    take a TMA body (phase 1 times it so), packs the same bytes."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = cs.k5_input(torch, gen, "cuda", "bfloat16", None, (1000, 700), view)
    layout = "col" if transpose else "row"
    want = pk.pack_b_plain(x, 128, 64, layout)
    out = torch.full_like(want, -1)
    rc = pk._kernel()(*pk.launch_args(
        x[None], 128, 64, col_order=True, transpose=transpose, nibble=False,
        body="general", out=out, stream=torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert rc == 0 and cs.same_bytes(torch, out, want)


@pytest.mark.cuda
def test_cuda_the_entry_refuses_a_body_that_cannot_take_the_call():
    _cuda()
    x = torch.zeros(1, 300, 200, dtype=BF16, device="cuda")
    out = torch.empty(1, 7, 5, 64, 32, dtype=BF16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    misaligned = x.flatten()[1:1 + 300 * 199].view(1, 300, 199)
    for body, xx in (("tma_stage", x), ("tma_copy", x.transpose(1, 2)),
                     ("tma_copy", misaligned), ("tma_stage", misaligned)):
        rc = pk._kernel()(*pk.launch_args(xx, 64, 32, col_order=True, transpose=False,
                                          nibble=False, body=body, out=out, stream=stream))
        assert rc != 0
