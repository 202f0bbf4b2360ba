"""Port vs reference: SYR2K, the paper's §5.1 extension. ``syr2k_layered``
(the triangle-only walk over packed normal and transposed copies) and
``syr2k_ref`` of the port against the reference's on the same numpy inputs,
in both triangles, with beta * C and odd n (the cases of test_syr2k.py):
f32, rtol = atol = 2e-4 (the reference test's tolerance: the products are
summed in other orders and blockings); ``syr2k_flops`` equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypo import given, settings, st

from repro.core import syr2k as jsyr2k
from repro_torch.core import syr2k as tsyr2k

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _nk(seed, n, k):
    r = np.random.default_rng(seed)
    a = r.normal(size=(n, k)).astype(np.float32)
    b = r.normal(size=(n, k)).astype(np.float32)
    c = r.normal(size=(n, n)).astype(np.float32)
    return a, b, (c + c.T) / 2  # symmetric C, as SYR2K requires


def _both(name, arrays, **kw):
    got = getattr(tsyr2k, name)(*(torch.from_numpy(x) for x in arrays), **kw)
    want = getattr(jsyr2k, name)(*(jnp.asarray(x) for x in arrays), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", ["syr2k_layered", "syr2k_ref"])
@pytest.mark.parametrize("n,k", [(64, 32), (100, 70), (33, 65)])
@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_matches_reference(name, n, k, uplo):
    got, want = _both(name, _nk(0, n, k), alpha=0.5, beta=2.0, uplo=uplo)
    np.testing.assert_allclose(got, want, **TOL)
    tri = np.tril if uplo == "lower" else np.triu
    assert np.array_equal(got, tri(got))  # the other triangle stays 0


def test_layered_walks_only_the_triangle(monkeypatch):
    """Two block products per on/below-diagonal C block, nothing above."""
    calls = []
    real = torch.einsum

    def counting(eq, *ops):
        calls.append(eq)
        return real(eq, *ops)

    monkeypatch.setattr(tsyr2k.torch, "einsum", counting)
    a, b, _ = _nk(1, 100, 20)
    plan = tsyr2k.plan_gemm(100, 20, 100, torch.float32)
    nb = -(-100 // min(plan.bm, plan.bn))
    tsyr2k.syr2k_layered(torch.from_numpy(a), torch.from_numpy(b), plan=plan)
    assert len(calls) == 2 * nb * (nb + 1) // 2


def test_triangles_reassemble_symmetric():
    a, b, _ = _nk(2, 48, 24)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    lo = tsyr2k.syr2k_layered(ta, tb, uplo="lower").numpy()
    up = tsyr2k.syr2k_layered(ta, tb, uplo="upper").numpy()
    np.testing.assert_allclose(lo + up - np.diag(np.diag(lo)),
                               a @ b.T + b @ a.T, **TOL)


@settings(max_examples=10, deadline=None)
@given(n=st.integers(4, 64), k=st.integers(1, 48))
def test_property_layered_equals_reference(n, k):
    a, b, _ = _nk(n * 101 + k, n, k)
    got, want = _both("syr2k_layered", (a, b))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("n,k", [(100, 10), (33, 65), (1, 1)])
def test_flops_equal(n, k):
    assert tsyr2k.syr2k_flops(n, k) == jsyr2k.syr2k_flops(n, k)
