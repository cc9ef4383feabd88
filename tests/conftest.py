"""Test harness: force an 8-device virtual CPU mesh so multi-chip sharding
(client axis + data axis) is exercised without TPUs.

NOTE: a pytest plugin imports jax before this conftest runs, so env vars
alone are too late; the platform must be switched through jax.config before
the backend is initialized (it is lazy).
"""

import os

# Single-core CI boxes: stop torch/XLA threadpools from thrashing each other.
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

try:
    import torch

    torch.set_num_threads(1)
except ImportError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running learning/integration tests"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA and nvcc; skips elsewhere"
    )


def pytest_sessionstart(session):
    assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
    assert jax.device_count() == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def rng():
    return np.random.default_rng(0)
