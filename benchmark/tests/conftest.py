"""Tests of the benchmark. Those that need a CUDA card carry the ``cuda``
marker and skip, with a reason, where none is visible (decided in the
``card`` fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
