"""Pytest settings of the benchmark's tests: the ``card`` marker (tests
that need a CUDA card and skip without one) and the fixture that decides
it when a test runs, never when a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
