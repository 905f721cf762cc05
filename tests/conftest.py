"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see the real single CPU
device; multi-device tests spawn subprocesses with their own flags."""

import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the hand-written kernels of "
        "repro_torch); skipped where there is none")
