"""Plain PyTorch versions of the GF(p) kernels (exact integer semantics).

These are the oracles the CPU tests hold the port to and the plain
versions ``chip_smoke.py`` holds each Hopper kernel against on the card.
Torch has no integer matmul on CUDA, so nothing here uses ``@`` on
integer tensors: each function is a Python loop over the contraction
(or over u for the circulant) of int64 elementwise multiply-adds, folded
on the envelope's int32 schedule (``int32_lazy_terms``) exactly as the
kernels fold.  The same code runs on the CPU and on the card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .envelope import int32_lazy_terms, require_int32_envelope


def _reduced(x: torch.Tensor, p: int) -> torch.Tensor:
    """x mod p with Python's sign rule, as int64."""
    return torch.remainder(x.to(torch.int64), p)


MAX_SOURCES = 4   # row sources a GF matmul's contraction operand may take


def matmul_sources(b) -> tuple:
    """The contraction operand ``b`` of a GF matmul as a tuple of row
    sources: one tensor, or a tuple or list of 1 to ``MAX_SOURCES``
    tensors read as if concatenated along the contraction axis (dim -2)."""
    if isinstance(b, torch.Tensor):
        return (b,)
    if not isinstance(b, (tuple, list)):
        raise TypeError(f"b must be a tensor or a tuple of tensors, got "
                        f"{type(b)}")
    if not 1 <= len(b) <= MAX_SOURCES:
        raise ValueError(f"b takes 1 to {MAX_SOURCES} row sources, got "
                         f"{len(b)}")
    for i, x in enumerate(b):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"b[{i}] must be a torch.Tensor, got {type(x)}")
    return tuple(b)


def gf_matmul_ref(a: torch.Tensor, b, p: int) -> torch.Tensor:
    """(a @ b) mod p with exact integer accumulation.

    a: (m, k) or (F, m, k); b: (k, s) or (F, k, s) integer tensors on
    one device, or a tuple of 1-4 such row sources, concatenated here
    along the contraction axis.  Leading batch axes broadcast.  Returns
    int32 on that device.
    """
    require_int32_envelope(p)
    src = matmul_sources(b)
    b = src[0] if len(src) == 1 else torch.cat(src, dim=-2)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    a = _reduced(a, p)
    k = a.shape[-1]
    chunk = int32_lazy_terms(p)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = torch.zeros(batch + (a.shape[-2], b.shape[-1]), dtype=torch.int64,
                      device=a.device)
    pending = 0
    for j in range(k):
        out += a[..., :, j, None] * _reduced(b[..., None, j, :], p)
        pending += 1
        if pending == chunk:
            out.remainder_(p)
            pending = 0
    return out.remainder_(p).to(torch.int32)


def circulant_encode_ref(data: torch.Tensor, c: Sequence[int],
                         p: int) -> torch.Tensor:
    """Redundancy blocks r[i] = sum_{u=1..k} c_u * data[(i - k - u) mod n]
    mod p (paper eq. (2)).  data: (n, s) with n = 2k; returns (n, s)
    int32.  Output row j holds r_{j+1}, i.e. sum_u c_u data[(j-k-u+1) mod n]:
    the k rolls of the reference, as rolls."""
    require_int32_envelope(p)
    c = [int(x) % p for x in c]
    k = len(c)
    n = data.shape[0]
    if n != 2 * k:
        raise ValueError(f"n={n} != 2k={2 * k}")
    data = _reduced(data, p)
    chunk = int32_lazy_terms(p)
    out = torch.zeros_like(data)
    pending = 0
    for u in range(1, k + 1):
        out.add_(torch.roll(data, shifts=k + u - 1, dims=0), alpha=c[u - 1])
        pending += 1
        if pending == chunk:
            out.remainder_(p)
            pending = 0
    return out.remainder_(p).to(torch.int32)


def gf_axpy_ref(y: torch.Tensor, alpha: int, x: torch.Tensor,
                p: int) -> torch.Tensor:
    """(y + alpha * x) mod p — the regenerate-path primitive."""
    require_int32_envelope(p)
    return torch.remainder(_reduced(y, p) + (int(alpha) % p) * _reduced(x, p),
                           p).to(torch.int32)


__all__ = ["gf_matmul_ref", "circulant_encode_ref", "gf_axpy_ref",
           "matmul_sources", "MAX_SOURCES"]
