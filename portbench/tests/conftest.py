"""The benchmark's own tests: on the CPU at a tiny configuration, and the
few that need the card (marker `card`, skipped without one: the decision is
made in the `card` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped on a machine without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest portbench/tests -m card)")
    return torch.device("cuda", 0)
