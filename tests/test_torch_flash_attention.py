"""Port vs reference: K4 ``flash_attention``. The plain torch version (what
the wrapper runs on CPU tensors) against the reference's Pallas
``flash_attention`` in interpret mode and its softmax oracle
``attention_ref`` on the same numpy inputs, over the reference test's cases
(f32: rtol = atol = 2e-4, the reference test's tolerance), with Sq > Skv
(rows that see no key are exactly 0 in both kernels; the oracle gives NaN
there), a window without causal masking, bf16 (0.1, the reference's own bf16
tolerance) and a sweep of Sq and Skv. The CUDA kernel is held against the
plain version on the card (``cuda`` marker; it skips here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypo import given, settings, st

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=2e-4)
CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window) — the reference test's CASES
    (2, 128, 128, 4, 2, 32, True, None),
    (1, 100, 100, 4, 4, 16, True, None),
    (2, 64, 64, 4, 1, 32, True, 24),        # MQA + sliding window
    (1, 1, 96, 4, 2, 16, True, None),       # decode: one right-aligned query
    (2, 48, 48, 2, 2, 16, False, None),     # bidirectional (encoder)
    (1, 37, 111, 3, 1, 8, True, None),      # ragged + cross-ish lengths
]


def _qkv(seed, b, sq, skv, h, hkv, d):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, sq, h, d)).astype(np.float32),
            r.normal(size=(b, skv, hkv, d)).astype(np.float32),
            r.normal(size=(b, skv, hkv, d)).astype(np.float32))


def _port(fn, arrays, dtype=torch.float32, **kw):
    out = fn(*(torch.from_numpy(x).to(dtype) for x in arrays), **kw)
    return out.to(torch.float32).numpy()


def _reference(fn, arrays, dtype=jnp.float32, **kw):
    out = fn(*(jnp.asarray(x, dtype) for x in arrays), **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", CASES)
def test_plain_matches_reference_kernel_and_oracle(b, sq, skv, h, hkv, d,
                                                   causal, window):
    x = _qkv(0, b, sq, skv, h, hkv, d)
    kw = dict(causal=causal, window=window)
    got = _port(fa.flash_attention_plain, x, **kw)
    np.testing.assert_allclose(
        got, _reference(jflash, x, bq=32, bkv=32, **kw), **F32)
    np.testing.assert_allclose(got, _reference(jref.attention_ref, x, **kw),
                               **F32)
    np.testing.assert_allclose(_port(tref.attention_ref, x, **kw),
                               _reference(jref.attention_ref, x, **kw), **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8)])
def test_rows_that_see_no_key_are_zero(causal, window):
    """Sq > Skv, causal: the first Sq - Skv queries sit before every key.
    Both kernels give exactly 0 there; the oracle gives NaN."""
    b, sq, skv, h, hkv, d = 2, 50, 20, 4, 2, 16
    x = _qkv(1, b, sq, skv, h, hkv, d)
    kw = dict(causal=causal, window=window)
    got = _port(fa.flash_attention_plain, x, **kw)
    want = _reference(jflash, x, bq=16, bkv=16, **kw)
    np.testing.assert_allclose(got, want, **F32)
    dead = sq - skv
    assert np.all(got[:, :dead] == 0.0) and np.all(want[:, :dead] == 0.0)
    assert np.all(np.isnan(_port(tref.attention_ref, x, **kw)[:, :dead]))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("window", [1, 5, 40])
def test_window_without_causal(window):
    x = _qkv(2, 1, 30, 40, 4, 2, 16)
    kw = dict(causal=False, window=window)
    got = _port(fa.flash_attention_plain, x, **kw)
    np.testing.assert_allclose(got, _reference(jflash, x, bq=16, bkv=16, **kw),
                               **F32)
    np.testing.assert_allclose(got, _reference(jref.attention_ref, x, **kw),
                               **F32)


def test_bf16_inputs():
    x = _qkv(3, 1, 32, 32, 2, 2, 16)
    got = _port(fa.flash_attention_plain, x, torch.bfloat16, causal=True)
    want = _reference(jflash, x, jnp.bfloat16, causal=True, bq=16, bkv=16)
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.1)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 12)])
@settings(max_examples=8, deadline=None)
@given(sq=st.integers(1, 48), skv=st.integers(1, 48))
def test_property_lengths(causal, window, sq, skv):
    """Any Sq and Skv (either longer), GQA: the plain version equals the
    reference kernel, rows that see no key included."""
    x = _qkv(sq * 101 + skv, 1, sq, skv, 4, 2, 8)
    kw = dict(causal=causal, window=window)
    np.testing.assert_allclose(
        _port(fa.flash_attention_plain, x, **kw),
        _reference(jflash, x, bq=16, bkv=16, **kw), **F32)


def test_plain_chunking_does_not_change_the_result(monkeypatch):
    """The plain version's query / batch / key-range chunking (which keeps
    its temporaries small at long context) gives the unchunked result."""
    x = _qkv(4, 3, 57, 80, 6, 2, 16)
    for causal, window in ((True, None), (True, 7), (False, 9)):
        kw = dict(causal=causal, window=window)
        whole = _port(fa.flash_attention_plain, x, **kw)
        monkeypatch.setattr(fa, "PLAIN_CHUNK_ELEMS", 300)
        np.testing.assert_allclose(_port(fa.flash_attention_plain, x, **kw),
                                   whole, rtol=1e-6, atol=1e-6)
        monkeypatch.undo()


def test_ops_attention_on_cpu_is_the_plain_version():
    x = _qkv(5, 2, 40, 40, 4, 1, 16)
    before = fa.flash_attention.launches
    for kw in (dict(), dict(causal=False), dict(window=9, scale=0.3)):
        np.testing.assert_array_equal(
            _port(ops.attention, x, **kw),
            _port(fa.flash_attention_plain, x, **kw))
    assert fa.flash_attention.launches == before  # the CPU launches nothing


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 3, 16)
    kv = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(torch.zeros(1, 4, 2, 16, device="meta"),
                           kv.to("meta"), kv.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """K4 against its plain version on the card, at the reference's cases,
    Sq > Skv, a window without causal, D = 128 and an odd D (f32 2e-4;
    bf16 / f16 rtol 2e-2, atol 1e-2: P is rounded to the input type for
    the PV product, the output once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tdt = getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=1e-2)
    for b, sq, skv, h, hkv, d, causal, window in CASES + [
            (1, 50, 20, 2, 1, 8, True, None), (1, 33, 90, 6, 2, 128, False, 17),
            (2, 130, 130, 4, 4, 128, True, None),
            (1, 40, 60, 4, 2, 37, True, None)]:
        x = [torch.from_numpy(a).cuda().to(tdt)
             for a in _qkv(6, b, sq, skv, h, hkv, d)]
        got = fa.flash_attention(*x, causal=causal, window=window)
        want = fa.flash_attention_plain(*x, causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
