"""pytest settings of the benchmark's own tests.

``perfbench_card`` marks a test that needs a CUDA card; its ``card``
fixture skips it where there is none (decided when the test runs, never
at import, so every worker collects the same tests).
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "perfbench_card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip machine")
    return torch.device("cuda", 0)
