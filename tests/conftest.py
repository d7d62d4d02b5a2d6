"""Registers the repository's pytest markers."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card with CUDA; skipped (by the "
        "`cuda` fixture of tests/_torch_parity.py) on hosts without one")
