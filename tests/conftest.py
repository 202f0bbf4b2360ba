"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real host
device count (the 512-device emulation belongs to launch/dryrun.py only)."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (dry-run compiles)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips elsewhere)")
