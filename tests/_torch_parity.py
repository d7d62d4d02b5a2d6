"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs come from seeded numpy and go through both the JAX reference and
the PyTorch port on the CPU; every comparison is exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch


def rand(shape, p, seed):
    return np.random.default_rng(seed).integers(
        0, p, size=shape, dtype=np.int64).astype(np.int32)


def t(x) -> torch.Tensor:
    """numpy -> CPU int32 tensor (copy, so nothing aliases the input)."""
    return torch.from_numpy(np.array(x, dtype=np.int32))


def npy(x) -> np.ndarray:
    """torch tensor or JAX/numpy array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def cuda():
    """The CUDA device; skips the test on hosts without a card.  Decided
    here, at run time, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


@pytest.fixture
def no_cuda(monkeypatch):
    """Make this host look CUDA-less, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
