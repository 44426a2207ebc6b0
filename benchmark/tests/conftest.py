"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repository. Tests marked `card` need a CUDA card; they ask for
the `cuda_device` fixture, which skips them where there is none (decided
when the test runs, never while the module is imported)."""
from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return torch.device("cuda", 0)
