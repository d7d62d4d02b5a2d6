"""Registers the repository's ``cuda`` marker for the benchmark's tests
and gives them the card, or a skip, from a fixture."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with CUDA; skipped (by the "
        "`card` fixture) on hosts without one")


@pytest.fixture
def card():
    """Skips the test on hosts without a CUDA card; decided when the test
    runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return "cuda"
