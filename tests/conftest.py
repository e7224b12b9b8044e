import numpy as np
import pytest

# NOTE: no XLA_FLAGS here -- smoke tests and benches must see 1 device.
# Distribution tests build their own small meshes in subprocesses or use
# the single device.


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
