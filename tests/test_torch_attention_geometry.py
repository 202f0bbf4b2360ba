"""Launch geometry of K4 (``flash_attention``): the pure-Python route
(``attention_body``), the TMA alignment test (``attention_tma_aligned``,
after ``attention_strides`` frees the strides of extent-1 dims), the tile
classes the TMA bodies give each key tile (``tile_class``, the mirror of
the CUDA source's ``visible_tiles`` / ``interior_tile``) against a
brute-force mask, the argument tuple and launch counts by body (pinned on
CPU tensors through a stubbed ``_kernel``, no launch), and the planted
faults of ``chip_smoke.py`` against the source they edit; and, on a card
(``cuda`` marker), each body against the plain version at its edges. The
file imports no JAX: ``PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_attention_geometry.py`` runs on the card."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as cfgs
from repro_torch.configs import shapes as shape_table
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# The C entry point's argument positions (flash_attention.py _ARGTYPES).
Q_STRIDES, K_STRIDES, V_STRIDES, BODY_ARG = slice(1, 4), slice(5, 8), slice(9, 12), 24


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _meta(*shape, dtype=BF16):
    """A contiguous tensor of this shape with no storage (the route reads
    shapes, strides and the base address only)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _case(b, sq, skv, h, hkv, d, dtype=BF16):
    return _meta(b, sq, h, d, dtype=dtype), _meta(b, skv, hkv, d, dtype=dtype)


# (B, Sq, Skv, H, Hkv, D, body in bf16 / f16): phase 6's A1-A6, then
# chip_smoke's ATTN_CASES and ATTN_EDGE_CASES, each with its body.
ROUTE_TABLE = [
    (4, 128, 128, 16, 16, 128, "wgmma"),      # A1 olmo-1b served prefill
    (4, 1, 160, 16, 16, 128, "stream"),       # A2 olmo-1b served decode
    (1, 32768, 32768, 16, 16, 128, "wgmma"),  # A3 prefill_32k
    (128, 1, 32768, 16, 16, 128, "stream"),   # A4 decode_32k
    (1, 32768, 32768, 48, 8, 128, "wgmma"),   # A5 mixtral prefill_32k
    (128, 1, 32768, 48, 8, 128, "stream"),    # A6 mixtral decode_32k
    (2, 128, 128, 4, 2, 32, "mma_general"), (1, 100, 100, 4, 4, 16, "mma_general"),
    (2, 64, 64, 4, 1, 32, "mma_general"), (1, 1, 96, 4, 2, 16, "mma_general"),
    (2, 48, 48, 2, 2, 16, "mma_general"), (1, 37, 111, 3, 1, 8, "mma_general"),
    (1, 50, 20, 2, 1, 8, "mma_general"), (2, 70, 40, 4, 2, 128, "wgmma"),
    (1, 33, 90, 6, 2, 128, "wgmma"), (2, 130, 130, 4, 4, 128, "wgmma"),
    (1, 65, 65, 2, 1, 256, "mma_general"), (1, 20, 300, 3, 3, 200, "mma_general"),
    (3, 1, 1000, 48, 8, 128, "stream"), (1, 40, 60, 4, 2, 37, "mma_general"),
    (2, 30, 30, 2, 2, 1, "mma_general"),
    (2, 1, 300, 48, 8, 128, "stream"),    # 6 rows
    (2, 2, 300, 48, 8, 128, "stream"),    # 12 rows
    (1, 3, 300, 48, 8, 128, "wgmma"),     # 18 rows
    (2, 1, 200, 4, 4, 128, "stream"),     # 1 row
    (1, 6, 200, 4, 4, 128, "stream"), (1, 12, 200, 4, 4, 64, "stream"),
    (1, 16, 200, 4, 4, 128, "stream"),    # the limit
    (1, 17, 200, 4, 4, 128, "wgmma"), (1, 18, 200, 2, 2, 64, "wgmma"),
    (1, 8, 150, 8, 4, 128, "stream"), (1, 9, 150, 8, 4, 128, "wgmma"),
    (1, 300, 300, 4, 2, 128, "wgmma"), (2, 200, 200, 2, 1, 64, "wgmma"),
    (1, 256, 333, 4, 4, 128, "wgmma"), (1, 100, 1000, 4, 4, 128, "wgmma"),
    (1, 512, 512, 2, 2, 128, "wgmma"), (1, 256, 256, 2, 1, 64, "wgmma"),
    (2, 1, 1024, 8, 8, 128, "stream"), (1, 130, 130, 2, 2, 256, "mma_general"),
    (1, 1000, 1000, 12, 2, 128, "wgmma"), (1, 700, 700, 6, 1, 64, "wgmma")]


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,want", ROUTE_TABLE)
def test_attention_body_follows_the_route_table(b, sq, skv, h, hkv, d, want, dtype):
    """bf16 / f16 that TMA can read with D 64 / 128: stream up to 16 rows
    (Sq * H / Hkv) per (batch, KV head), wgmma above; every other head dim
    mma_general; the masks do not change the body."""
    q, kv = _case(b, sq, skv, h, hkv, d, dtype)
    assert fa.attention_body(q, kv, kv) == want
    assert fa.attention_body(q, kv, kv, False, 7) == want


@pytest.mark.parametrize("b,sq,skv,h,hkv,d", [r[:6] for r in ROUTE_TABLE[:6]])
def test_f32_takes_the_f32_body(b, sq, skv, h, hkv, d):
    q, kv = _case(b, sq, skv, h, hkv, d, F32)
    assert fa.attention_body(q, kv, kv) == "f32"


def test_route_table_covers_every_edge_case_of_chip_smoke():
    """Every shape chip_smoke's phase 1 holds K4 to is pinned above."""
    cs = _chip_smoke()
    pinned = {r[:6] for r in ROUTE_TABLE}
    for shape in cs.ATTN_CASES + cs.ATTN_EDGE_CASES:
        assert shape[:6] in pinned, shape


def test_phase6_shapes_take_their_bodies():
    """chip_smoke's ATTN_SHAPE_BODY (the body phase 6 asserts) is the one
    the route names at each of A1-A6, from configs.shapes."""
    cs = _chip_smoke()
    got = {}
    for tag, cfg, b, sq, skv, window, _ in cs.attention_shapes(cfgs, shape_table):
        q, kv = _case(b, sq, skv, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        got[tag] = fa.attention_body(q, kv, kv, True, window)
    assert got == cs.ATTN_SHAPE_BODY
    assert set(got.values()) == {"wgmma", "stream"}


def _strided(shape, strides, offset=0, dtype=BF16):
    span = 1 + offset + sum((n - 1) * st for n, st in zip(shape, strides))
    return torch.zeros(span, dtype=dtype).as_strided(shape, strides, offset)


def _qkv(b, s, h, d, dtype=BF16):
    """q, k, v as views of one fused [B, S, 3, H, D] tensor."""
    t = torch.zeros(b, s, 3, h, d, dtype=dtype)
    return t[:, :, 0], t[:, :, 1], t[:, :, 2]


@pytest.mark.parametrize("make,aligned", [
    (lambda: (torch.zeros(2, 64, 4, 128, dtype=BF16),) * 3, True),
    (lambda: _qkv(2, 77, 4, 64), True),
    (lambda: _qkv(2, 1, 8, 128), True),
    # [B, H, S, D] storage read as [B, S, H, D]: heads outside the sequence
    (lambda: tuple(torch.zeros(1, 8, 40, 128, dtype=BF16).transpose(1, 2)
                   for _ in range(3)), True),
    # q offset by one element: base off 16 bytes
    (lambda: (torch.zeros(1 + 2 * 64 * 4 * 128, dtype=BF16)[1:].view(2, 64, 4, 128),
              torch.zeros(2, 64, 4, 128, dtype=BF16),
              torch.zeros(2, 64, 4, 128, dtype=BF16)), False),
    # D = 37: the head stride 37 elements is off 16 bytes
    (lambda: (torch.zeros(1, 40, 4, 37, dtype=BF16),) * 3, False),
    # head dim not contiguous
    (lambda: (torch.zeros(2, 64, 128, 4, dtype=BF16).transpose(2, 3),) * 3, False),
    # k broadcast over the batch (stride 0)
    (lambda: (torch.zeros(2, 8, 2, 64, dtype=BF16),
              torch.zeros(1, 8, 2, 64, dtype=BF16).expand(2, 8, 2, 64),
              torch.zeros(2, 8, 2, 64, dtype=BF16)), False),
    # a sequence stride off 16 bytes (a row of 4 heads x 64 + 4 elements)
    (lambda: (_strided((1, 8, 4, 64), (8 * 260, 260, 64, 1)),) * 3, False),
    # no keys
    (lambda: (torch.zeros(1, 4, 2, 64, dtype=BF16),
              torch.zeros(1, 0, 2, 64, dtype=BF16),
              torch.zeros(1, 0, 2, 64, dtype=BF16)), False),
    # extent-1 dims with strides torch leaves free (and odd)
    (lambda: (_strided((1, 1, 1, 128), (3, 5, 7, 1)),
              _strided((1, 40, 1, 128), (1, 128, 9, 1)),
              _strided((1, 40, 1, 128), (1, 128, 9, 1))), True),
])
def test_attention_tma_alignment(make, aligned):
    q, k, v = make()
    assert fa.attention_tma_aligned(q, k, v) is aligned


@pytest.mark.parametrize("t,want", [
    (torch.zeros(2, 64, 4, 128, dtype=BF16), (64 * 512, 512, 128)),
    # decode q [B, 1, H, D]: the free sequence stride becomes H * D
    (_strided((4, 1, 16, 128), (2048, 1, 128, 1)), (2048, 2048, 128)),
    # one head, one position, one batch entry: spans rounded to 16 bytes
    (_strided((1, 1, 1, 37), (3, 5, 7, 1)), (40, 40, 40)),
    (_strided((1, 40, 1, 128), (1, 128, 9, 1)), (40 * 128, 128, 128)),
    # a fused qkv view keeps the strides it steps
    (_qkv(2, 77, 4, 64)[1], (77 * 3 * 256, 3 * 256, 64)),
])
def test_attention_strides_free_the_strides_of_extent_one_dims(t, want):
    assert fa.attention_strides(t) == want


def _mask(sq, skv, causal, window):
    """The brute-force visibility mask [Sq, Skv] of the reference."""
    q_pos = np.arange(sq)[:, None] + (skv - sq)
    k_pos = np.arange(skv)[None, :]
    m = np.ones((sq, skv), dtype=bool)
    if causal:
        m &= q_pos >= k_pos
    if window is not None:
        m &= q_pos - k_pos < window
    return m


@pytest.mark.parametrize("sq,skv,causal,window", [
    (300, 300, True, None),     # causal: the diagonal
    (300, 300, True, 100),      # window and causal
    (300, 300, False, 64),      # window without causal
    (256, 256, True, 128),      # a window edge on a tile edge
    (256, 256, True, 129),      # ... one key off it
    (400, 150, True, None),     # Sq > Skv: rows that see nothing
    (100, 1000, True, None),    # Sq < Skv
    (100, 1000, True, 200),
    (1, 1000, True, None),      # decode
    (1, 1000, True, 64),
    (16, 333, False, None),     # no mask but the Skv tail
])
@pytest.mark.parametrize("rows,bkv", [(fa.WGMMA_ROWS, fa.WGMMA_KEYS), (64, fa.WGMMA_KEYS),
                                      (fa.STREAM_ROWS, fa.STREAM_KEYS)])
def test_tile_classes_agree_with_the_brute_force_mask(sq, skv, causal, window, rows, bkv):
    """For every row tile and key tile: an invisible tile holds no visible
    (query, key) pair, an interior tile only visible ones (so skipping its
    mask changes nothing), and an edge tile at least one pair the mask must
    drop (else it would be interior)."""
    m = _mask(sq, skv, causal, window)
    for i0 in range(0, sq, rows):
        i1 = min(sq, i0 + rows)
        for j in range(-(-skv // bkv)):
            block = m[i0:i1, j * bkv:(j + 1) * bkv]
            full = block.shape[1] == bkv
            cls = fa.tile_class(sq, skv, causal, window, i0, i1 - 1, j, bkv)
            if cls == "invisible":
                assert not block.any(), (i0, j)
            elif cls == "interior":
                assert full and block.all(), (i0, j)
            else:
                assert not (full and block.all()), (i0, j)


def test_at_prefill_32k_the_mask_runs_on_few_tiles():
    """A3's causal 32k, 64-row warpgroups against 128-key tiles: each
    warpgroup masks exactly one tile (its diagonal) and takes every tile
    below it unmasked, 65280 interior tiles against 512 edge ones."""
    sq = 32768
    classes = [fa.tile_class(sq, sq, True, None, i0, i0 + 63, j, fa.WGMMA_KEYS)
               for i0 in range(0, sq, 64) for j in range(sq // fa.WGMMA_KEYS)]
    assert classes.count("edge") == sq // 64
    assert classes.count("interior") == 255 * 256


# -- the argument tuple and the launch counts, through a stubbed kernel ----

@pytest.mark.parametrize("make,body", [
    (lambda: (torch.zeros(2, 40, 4, 128, dtype=BF16), torch.zeros(2, 60, 2, 128, dtype=BF16)),
     "wgmma"),
    (lambda: (torch.zeros(2, 1, 48, 128, dtype=F16), torch.zeros(2, 300, 8, 128, dtype=F16)),
     "stream"),
    (lambda: (torch.zeros(1 + 2 * 40 * 4 * 64, dtype=BF16)[1:].view(2, 40, 4, 64),
              torch.zeros(2, 60, 2, 64, dtype=BF16)), "mma_general"),
    (lambda: (torch.zeros(2, 40, 4, 64), torch.zeros(2, 60, 2, 64)), "f32"),
])
def test_launches_are_counted_by_body(monkeypatch, make, body):
    """One launch adds one to ``launches`` and to ``variants[body]``, the
    body whose code the C entry point was handed; a failed launch raises,
    names its body and counts nothing."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 1
    monkeypatch.setattr(fa, "_kernel", lambda: kernel)
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(fa.flash_attention, "variants",
                        dict.fromkeys(fa.ATTENTION_BODIES, 0))
    q, kv = make()
    kw = dict(causal=True, window=None, scale=None, stream=None)
    out = fa._launch(q, kv, kv, **kw)
    assert tuple(out.shape) == tuple(q.shape) and out.dtype == q.dtype
    assert fa.flash_attention.launches == 1 and fa.flash_attention.variants[body] == 1
    assert sum(fa.flash_attention.variants.values()) == 1
    args = calls[0]
    assert len(args) == len(fa._ARGTYPES)
    assert args[BODY_ARG] == fa.BODY[body]
    assert args[Q_STRIDES] == fa.attention_strides(q)
    assert args[K_STRIDES] == args[V_STRIDES] == fa.attention_strides(kv)
    with pytest.raises(RuntimeError, match=body):
        fa._launch(q, kv, kv, **kw)
    assert fa.flash_attention.launches == 1
    assert sum(fa.flash_attention.variants.values()) == 1


def test_launch_args_pass_the_masks_and_the_scale():
    q, kv = torch.zeros(1, 20, 4, 64, dtype=BF16), torch.zeros(1, 30, 2, 64, dtype=BF16)
    out = torch.empty_like(q)
    args, body = fa.launch_args(q, kv, kv, out, causal=False, window=9, scale=0.5,
                                stream=None)
    assert body == "wgmma"
    assert args[13:24] == (fa.DT["bfloat16"], 1, 20, 30, 4, 2, 64, 0, 1, 9, 0.5)
    args, _ = fa.launch_args(q, kv, kv, out, causal=True, window=None, scale=None,
                             stream=None)
    assert args[20:24] == (1, 0, 0, 1 / 8)


def test_a_non_unit_last_stride_is_copied_before_the_route(monkeypatch):
    """The wrapper copies a tensor whose head dim is not contiguous, so the
    copy (aligned) takes a TMA body."""
    calls = []
    monkeypatch.setattr(fa, "_kernel", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(fa.flash_attention, "variants",
                        dict.fromkeys(fa.ATTENTION_BODIES, 0))
    q = torch.zeros(1, 40, 128, 4, dtype=BF16).transpose(2, 3)
    kv = torch.zeros(1, 40, 4, 128, dtype=BF16)
    assert fa.attention_body(q, kv, kv) == "mma_general"
    fa._launch(q, kv, kv, causal=True, window=None, scale=None, stream=None)
    assert calls[0][BODY_ARG] == fa.BODY["wgmma"]
    assert fa.flash_attention.variants["wgmma"] == 1


def test_empty_outputs_launch_nothing(monkeypatch):
    monkeypatch.setattr(fa, "_kernel", lambda: pytest.fail("launched"))
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    empty = torch.zeros(0, 4, 2, 64, dtype=BF16)
    assert fa._launch(empty, empty, empty, causal=True, window=None, scale=None,
                      stream=None).numel() == 0
    assert fa.flash_attention.launches == 0


def test_flash_attention_counts_every_body():
    assert set(fa.flash_attention.variants) == set(fa.ATTENTION_BODIES) == set(fa.BODY)
    assert sorted(fa.BODY.values()) == [0, 1, 2, 3]


def test_counters_reset_zeroes_k4_bodies():
    cs = _chip_smoke()
    counters = cs.Counters([fa.flash_attention])
    saved = (fa.flash_attention.launches, dict(fa.flash_attention.variants))
    try:
        fa.flash_attention.launches, fa.flash_attention.variants["wgmma"] = 3, 2
        counters.reset()
        assert counters.read() == {"flash_attention": 0}
        assert counters.variants() == {"flash_attention": dict.fromkeys(
            fa.ATTENTION_BODIES, 0)}
    finally:
        fa.flash_attention.launches = saved[0]
        fa.flash_attention.variants.update(saved[1])


# -- planted faults ---------------------------------------------------------

@pytest.mark.parametrize("i", range(7))
def test_k4_faults_edit_the_source_exactly_once(i):
    """``chip_smoke.py --planted-faults`` applies each K4 fault's edits to
    a copy of flash_attention.cu: every edited text must sit in it exactly
    once, so that a fault cannot silently miss."""
    faults = _chip_smoke().K4_FAULTS
    assert len(faults) == 7
    name, edits, _ = faults[i]
    text = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in edits:
        assert text.count(old) == 1, (name, old)
        assert old != new
        text = text.replace(old, new)


@pytest.mark.parametrize("name,reached", [
    ("one KV tile dropped", {"A1", "A2", "A3", "A4", "A5", "A6"}),
    ("causal edge one key in", {"A1", "A2", "A3", "A4", "A5", "A6"}),
    ("window edge one key in", {"A5", "A6"}),
    ("window edge one key out", {"A5", "A6"}),
    ("edge tile taken as interior (diagonal one tile off)", {"A1", "A3", "A5"}),
    ("wgmma: the ring one KV tile short", {"A1", "A3", "A5"}),
    ("stream: warp 0's partial dropped from the combine", {"A2", "A4", "A6"}),
])
def test_k4_faults_name_the_shapes_they_reach(name, reached):
    """Each fault reaches the phase-6 shapes whose body runs the code it
    edits: the new bodies' faults exactly the shapes of their body."""
    cs = _chip_smoke()
    reach = {n: r for n, _, r in cs.K4_FAULTS}[name]
    got = {tag for tag, _, _, sq, _, window, _ in cs.attention_shapes(cfgs, shape_table)
           if reach(sq, window)}
    assert got == reached


# -- on the card: each body against its plain version at its edges ---------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _randn(rng, *shape, dtype=BF16):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().to(dtype)


def _close(q, k, v, causal, window, dtype_name):
    """K4 against flash_attention_plain under chip_smoke's ATTN_TOL, on the
    body attention_body names; rows that see no key exactly 0."""
    cs = _chip_smoke()
    body = fa.attention_body(q, k, v, causal, window)
    before = dict(fa.flash_attention.variants)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = [b for b, c in fa.flash_attention.variants.items() if c != before[b]]
    assert ran == [body]
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    ok, err, norm, why = cs.attention_close(got, want, *cs.ATTN_TOL[dtype_name])
    assert ok, (body, err, norm, why)
    dead = q.shape[1] - k.shape[1] if causal else 0
    assert dead <= 0 or bool((got[:, :dead] == 0).all())
    return body


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", [
    (2, 1, 300, 48, 8, 128, True, None), (2, 2, 300, 48, 8, 128, True, None),
    (1, 3, 300, 48, 8, 128, True, 100), (2, 1, 200, 4, 4, 128, True, None),
    (1, 16, 200, 4, 4, 128, True, None), (1, 17, 200, 4, 4, 128, True, None),
    (1, 12, 200, 4, 4, 64, True, 50), (1, 18, 200, 2, 2, 64, False, None),
    (1, 300, 300, 4, 2, 128, True, None), (1, 256, 333, 4, 4, 128, True, None),
    (1, 100, 1000, 4, 4, 128, True, 200), (1, 512, 512, 2, 2, 128, True, 128),
    (1, 512, 512, 2, 2, 128, True, 129), (1, 256, 256, 2, 1, 64, False, 128),
    (2, 1, 1024, 8, 8, 128, True, 64), (2, 1, 1024, 8, 8, 128, True, 65),
    (1, 400, 150, 4, 4, 128, True, None), (1, 130, 130, 2, 2, 256, True, None),
    (1, 40, 60, 4, 2, 37, True, None)])
def test_cuda_k4_bodies_at_edge_shapes(b, sq, skv, h, hkv, d, causal, window, dtype):
    _cuda()
    rng = np.random.default_rng(sq * 1000 + skv)
    dt = getattr(torch, dtype)
    _close(_randn(rng, b, sq, h, d, dtype=dt), _randn(rng, b, skv, hkv, d, dtype=dt),
           _randn(rng, b, skv, hkv, d, dtype=dt), causal, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s_len,d,body", [(77, 64, "wgmma"), (77, 128, "wgmma"),
                                          (1, 128, "stream"), (1, 64, "stream")])
def test_cuda_k4_fused_qkv_views_on_tma(s_len, d, body):
    _cuda()
    qkv = _randn(np.random.default_rng(s_len + d), 2, s_len, 3, 8, d)
    assert _close(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True, None,
                  "bfloat16") == body


@pytest.mark.cuda
@pytest.mark.parametrize("sq,body", [(40, "wgmma"), (2, "stream")])
def test_cuda_k4_heads_stored_outside_the_sequence(sq, body):
    """[B, H, S, D] storage read as [B, S, H, D]: the maps order the dims by
    stride, and the stream body finds each row of the group in its box."""
    _cuda()
    rng = np.random.default_rng(sq)
    q = _randn(rng, 1, 8, sq, 128).transpose(1, 2)
    kv = _randn(rng, 2, 2, 60, 128)
    assert _close(q, kv[0:1].transpose(1, 2), kv[1:2].transpose(1, 2), True, None,
                  "bfloat16") == body


@pytest.mark.cuda
def test_cuda_k4_misaligned_q_takes_mma_general():
    _cuda()
    rng = np.random.default_rng(3)
    buf = _randn(rng, 1 + 2 * 64 * 4 * 128)
    assert _close(buf[1:].view(2, 64, 4, 128), _randn(rng, 2, 64, 4, 128),
                  _randn(rng, 2, 64, 4, 128), True, None, "bfloat16") == "mma_general"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_k4_p_packing_at_one_key_a_tile_column(d):
    """The wgmma body's P -> A-fragment packing at D 64 and 128: key k
    scores (k % 5) / 2 against every query and its V row is one-hot at
    column k % d, so each output column is the weight of its own keys; a
    fragment put at the wrong key, row or column moves weight between
    columns or rows."""
    _cuda()
    skv, h = 256, 2
    q = torch.zeros(1, skv, h, d, device="cuda", dtype=BF16)
    k = torch.zeros_like(q)
    v = torch.zeros_like(q)
    q[..., 0] = 1.0
    for key in range(skv):
        k[0, key, :, 0] = (key % 5) / 2
        v[0, key, :, key % d] = 1.0
    assert _close(q, k, v, True, None, "bfloat16") == "wgmma"
