"""Every strategy of the paper's comparison on the card, without JAX: the
port's ``matmul`` facade for each strategy against the f32 product (the
machine with the card has no JAX, so the card's strategy test lives here;
``tests/test_torch_strategy.py`` holds the same strategies against the
reference on the CPU). Skips without a card (``cuda`` marker)."""
import numpy as np
import pytest
import torch

from repro_torch.core import gemm as tgemm
from repro_torch.core import strategy as tstrat


def _data(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", tstrat.STRATEGIES)
def test_cuda_strategies_match_the_f32_product(strategy, dtype):
    """On the card every strategy's kernels against the f32 product
    (relative to max|C|: f32 1e-4, bf16 output 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    a, b = (torch.from_numpy(x).cuda() for x in _data(65, 130, 97))
    got = tgemm.matmul(a.to(dtype), b.to(dtype), strategy=strategy)
    want = a.to(dtype).float() @ b.to(dtype).float()
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert got.dtype == dtype and err <= (1e-4 if dtype == torch.float32
                                          else 1e-2)


def test_every_strategy_is_listed_once():
    """The card test above runs each of the paper's eight strategies."""
    assert len(tstrat.STRATEGIES) == len(set(tstrat.STRATEGIES)) == 8
