"""Public GF(p) compute entry points, backend-dispatched (the port of
``repro.kernels.ops``).

Every call routes through the :mod:`repro_torch.kernels.dispatch`
registry: the Hopper kernels for a CUDA device, the plain torch versions
for the CPU, pinnable per call (``backend=``), per process
(:func:`dispatch.set_default_backend`) or via ``REPRO_TORCH_GF_BACKEND``.

Inputs may be tensors (their device is used) or numpy arrays / lists,
which go to ``device`` — None is the card, and there is no silent CPU
fallback.  Results are int32 tensors on that device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import as_int32, device_of

from . import dispatch, ref


def _resolve(backend: Optional[str], p: int, k: Optional[int],
             device) -> dispatch.GFBackend:
    if backend is None:
        return dispatch.select(p, k, device)
    return dispatch.get(backend)


def gf_matmul(a, b, p: int = 257, *, backend: Optional[str] = None,
              device=None) -> torch.Tensor:
    """Exact (a @ b) mod p — dispatched to the exact backend for the
    device.  a: (m, k) or (F, m, k); b: (k, s) or (F, k, s)."""
    dev = device_of(a, b, device=device)
    a, b = as_int32(a, p, dev), as_int32(b, p, dev)
    return _resolve(backend, p, a.shape[-1], dev).matmul(a, b, p)


def circulant_encode(data, c, p: int = 257, *, backend: Optional[str] = None,
                     device=None) -> torch.Tensor:
    """MSR redundancy blocks from data blocks (paper eq. (2)) — dispatched."""
    c = tuple(int(x) for x in c)
    if any(x % p == 0 for x in c):
        raise ValueError("coefficients must be nonzero (paper §III-A)")
    dev = device_of(data, device=device)
    data = as_int32(data, p, dev)
    return _resolve(backend, p, len(c), dev).circulant_encode(data, c, p)


def gf_axpy(y, alpha: int, x, p: int = 257, *, backend: Optional[str] = None,
            device=None) -> torch.Tensor:
    """(y + alpha * x) mod p — the regenerate-path primitive, dispatched."""
    dev = device_of(y, x, device=device)
    y, x = as_int32(y, p, dev), as_int32(x, p, dev)
    return _resolve(backend, p, None, dev).axpy(y, alpha, x, p)


def msr_matmul_backend(p: int = 257, *, backend: Optional[str] = None,
                       device=None):
    """A drop-in `matmul(a, b, p)` for DoubleCirculantMSR(..., matmul=...)."""
    def matmul(a, b, p_inner=p):
        return gf_matmul(a, b, p_inner, backend=backend, device=device)
    return matmul


# re-export oracles for test convenience
gf_matmul_ref = ref.gf_matmul_ref
circulant_encode_ref = ref.circulant_encode_ref
gf_axpy_ref = ref.gf_axpy_ref

__all__ = ["gf_matmul", "circulant_encode", "gf_axpy", "msr_matmul_backend",
           "gf_matmul_ref", "circulant_encode_ref", "gf_axpy_ref", "dispatch"]
