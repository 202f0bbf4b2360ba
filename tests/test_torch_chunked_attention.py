"""Served attention: the port's ``models.layers.chunked_attention`` against
the reference's ``repro.models.layers.chunked_attention`` on the same numpy
inputs, and the widened copies of K and V made once a call (not once a
query chunk)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.layers import chunked_attention as ref_chunked
from repro_torch.models.layers import chunked_attention

torch.set_num_threads(1)

# (B, Sq, Skv, H, Hkv, D, causal, window, chunk): several chunks with a
# ragged last one, GQA, a window, no mask.
CASES = [(2, 40, 40, 4, 2, 16, True, None, 16),
         (1, 64, 64, 4, 1, 32, True, 24, 16),
         (2, 33, 33, 2, 2, 16, False, None, 8),
         (1, 48, 48, 6, 3, 16, True, 5, 48)]


def _inputs(b, sq, skv, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


def _both(q, k, v, dtype, **kw):
    """(port, reference) outputs as f32 numpy; q / k / v rounded to
    ``dtype`` first on both sides."""
    tq = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    got = chunked_attention(*tq, **kw).float().numpy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jkw = {n: (jnp.asarray(x.numpy()) if torch.is_tensor(x) else x)
           for n, x in kw.items()}
    want = ref_chunked(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)), **jkw)
    return got, np.asarray(want.astype(jnp.float32))


# bf16: both sides take the same exact bf16 products in f32 and round the
# softmax weights to bf16 before the value product; sums run in other
# orders, so a weight near a rounding edge can round the other way (2^-8 of
# that weight), and the output rounds to bf16 (2^-8 relative): 2e-2
# absolute for outputs of order 1.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_reference(case, dtype):
    b, sq, skv, h, hkv, d, causal, window, chunk = case
    q, k, v = _inputs(b, sq, skv, h, hkv, d, seed=sq + h)
    got, want = _both(q, k, v, dtype, causal=causal, window=window,
                      chunk=chunk)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_ring_cache_matches_reference(dtype, window):
    """One query a row against a ring cache of 16 slots, as
    ``decode_attention`` calls it: rotated key positions, ``kv_valid``
    (slots not yet written, and outside the window), GQA, chunk 1."""
    b, slots, h, hkv, d = 3, 16, 4, 2, 16
    q, k, v = _inputs(b, 1, slots, h, hkv, d, seed=7)
    pos = np.array([3, 15, 21])
    slot_ids = np.arange(slots)[None]
    k_pos = pos[:, None] - ((pos[:, None] - slot_ids) % slots)
    valid = k_pos >= 0
    if window is not None:
        valid &= (pos[:, None] - k_pos) < window
    got, want = _both(q, k, v, dtype, causal=True, window=window,
                      q_positions=torch.from_numpy(pos[:, None]),
                      k_positions=torch.from_numpy(k_pos),
                      kv_valid=torch.from_numpy(valid), chunk=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


class _Copies(TorchDispatchMode):
    """Counts dtype conversions by the shape of their input."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("chunk", [8, 64])
def test_kv_widened_once_a_call(chunk):
    """bf16 K and V are each widened to f32 once a call, however many query
    chunks there are (8 chunks or 1 here)."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 64, 64, 4, 2, 16, seed=3))
    with _Copies() as mode:
        chunked_attention(q, k, v, causal=True, chunk=chunk)
    assert mode.shapes.count(tuple(k.shape)) == 2  # K once, V once
