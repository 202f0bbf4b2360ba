"""K7's plain version against the reference kernel at the operands its TMA
bodies serve: ``repro_torch.kernels.gemm_tiled.gemm_tiled_plain`` (what
the wrapper runs on CPU tensors, and the oracle the card's bodies are held
to) against ``repro.kernels.gemm_tiled.gemm_tiled`` (Pallas in interpret
mode) on the same numpy inputs. The port sees B as the raw LM head does,
``table.t()`` (a transposed view), or as a column slice of a wider matrix
(ldb > N) whose columns past N hold NaN; A as a view whose columns past K
hold NaN; K = 700 (a last 64-deep box that is part padding). The reference
gets the same values as dense arrays. Tolerances: f32 rtol = atol = 1e-5
(the same f32 products summed in other orders), bf16 rtol = atol = 1e-2
(f32 sums rounded once to bf16: one ulp is 2^-8 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm_tiled import gemm_tiled as ref_gemm_tiled
from repro_torch.kernels import gemm_tiled as gt

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def _view(x: np.ndarray, dtype, transposed=False) -> torch.Tensor:
    """``x`` [r, c] as a torch view of a wider buffer whose columns past c
    hold NaN; with ``transposed`` the view is ``table.t()`` of x.T."""
    rows, cols = x.T.shape if transposed else x.shape
    buf = torch.full((rows, cols + 8), float("nan"))
    buf[:, :cols] = torch.from_numpy(np.ascontiguousarray(x.T if transposed
                                                          else x))
    view = buf.to(dtype)[:, :cols]
    return view.t() if transposed else view


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 37])
@pytest.mark.parametrize("layout", ["table.t()", "ldb > N"])
def test_plain_matches_the_reference_kernel(dtype, m, layout):
    k, n = 700, 200
    rng = np.random.default_rng(m + len(layout))
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ta, tb = _view(a, tdt), _view(b, tdt, transposed=layout == "table.t()")
    assert ta.stride(0) > k and (tb.stride(0) == 1 if layout == "table.t()"
                                 else tb.stride(0) > n)
    got = gt.gemm_tiled(ta, tb)          # CPU tensors: the plain version
    want = ref_gemm_tiled(jnp.asarray(a, jdt), jnp.asarray(b, jdt), bm=64,
                          bk=128, bn=128)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["gelu", "silu"])
def test_plain_epilogue_matches_the_reference_kernel(dtype, epilogue):
    """The fused store epilogue on the same operands: alpha, beta * C and
    the bias, then the activation (f32 C, output in C's dtype)."""
    m, k, n = 4, 700, 200
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    got = gt.gemm_tiled(_view(a, tdt), _view(b, tdt, transposed=True),
                        torch.from_numpy(c), alpha=1.5, beta=0.5,
                        bias=torch.from_numpy(bias), epilogue=epilogue)
    want = ref_gemm_tiled(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                          jnp.asarray(c), alpha=1.5, beta=0.5,
                          bias=jnp.asarray(bias), epilogue=epilogue, bm=64,
                          bk=128, bn=128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
