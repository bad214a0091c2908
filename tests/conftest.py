"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(only launch/dryrun.py forces 512 placeholder devices, in its own process).
"""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (inside the test) without one")
