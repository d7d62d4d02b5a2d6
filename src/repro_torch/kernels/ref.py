"""Plain PyTorch versions of the GF(p) kernels (exact integer semantics).

These are the oracles the CPU tests hold the port to and the plain
versions ``chip_smoke.py`` holds each Hopper kernel against on the card.
Torch has no integer matmul on CUDA, so nothing here uses ``@`` on
integer tensors: each function is a Python loop over the contraction
(or over u for the circulant) of int64 elementwise multiply-adds, folded
on the envelope's int32 schedule (``int32_lazy_terms``) exactly as the
kernels fold.  The same code runs on the CPU and on the card.

Each takes the kernels' window semantics: a stream operand may be a
column window of a larger tensor (unit stride along the stream, any row
pitch: :func:`row_layout`), and ``out=`` a window to write in place.
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


def row_layout(t: torch.Tensor, name: str, *, out: bool = False,
               ) -> tuple[int, int]:
    """(row pitch, batch stride) in elements of a (rows, s) or (F, rows,
    s) stream operand: a column window of a larger tensor is fine as long
    as its symbols are adjacent along the stream (unit stride).  An
    output window must not overlap itself: pitch >= s and batch stride >=
    rows * pitch.  A size-1 axis's stride is free; it is reported as the
    tightest layout's."""
    s = t.shape[-1]
    rows = t.shape[-2] if t.dim() >= 2 else 1
    if s > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along the stream "
                         f"axis (unit stride), got strides "
                         f"{tuple(t.stride())}")
    ld = t.stride(-2) if t.dim() >= 2 and rows > 1 else s
    bstride = t.stride(0) if t.dim() == 3 and t.shape[0] > 1 else rows * ld
    if out and (ld < s or bstride < rows * ld):
        raise ValueError(f"{name} overlaps itself: shape {tuple(t.shape)}, "
                         f"strides {tuple(t.stride())}")
    return ld, bstride


def _into(res: torch.Tensor, out) -> torch.Tensor:
    """``res`` written into ``out`` (checked) when given, else ``res``."""
    if out is None:
        return res
    if out.shape != res.shape or out.dtype != torch.int32 or \
            out.device != res.device:
        raise ValueError(f"out must be int32 {tuple(res.shape)} on "
                         f"{res.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    row_layout(out, "out", out=True)
    return out.copy_(res)


def gf_matmul_ref(a: torch.Tensor, b, p: int, out=None) -> torch.Tensor:
    """(a @ b) mod p with exact integer accumulation.

    a: (m, k) or (F, m, k); b: (k, s) or (F, k, s) integer tensors on
    one device, or a tuple of 1-4 such row sources, concatenated here
    along the contraction axis.  Leading batch axes broadcast.  Returns
    int32 on that device, written into ``out`` when given.
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
    acc = torch.zeros(batch + (a.shape[-2], b.shape[-1]), dtype=torch.int64,
                      device=a.device)
    pending = 0
    for j in range(k):
        acc += a[..., :, j, None] * _reduced(b[..., None, j, :], p)
        pending += 1
        if pending == chunk:
            acc.remainder_(p)
            pending = 0
    return _into(acc.remainder_(p).to(torch.int32), out)


def circulant_encode_ref(data: torch.Tensor, c: Sequence[int],
                         p: int, out=None) -> torch.Tensor:
    """Redundancy blocks r[i] = sum_{u=1..k} c_u * data[(i - k - u) mod n]
    mod p (paper eq. (2)).  data: (n, s) with n = 2k; returns (n, s)
    int32 (into ``out`` when given).  Output row j holds r_{j+1}, i.e.
    sum_u c_u data[(j-k-u+1) mod n]: the k rolls of the reference, as
    rolls."""
    require_int32_envelope(p)
    c = [int(x) % p for x in c]
    k = len(c)
    n = data.shape[0]
    if n != 2 * k:
        raise ValueError(f"n={n} != 2k={2 * k}")
    data = _reduced(data, p)
    chunk = int32_lazy_terms(p)
    acc = torch.zeros_like(data)
    pending = 0
    for u in range(1, k + 1):
        acc.add_(torch.roll(data, shifts=k + u - 1, dims=0), alpha=c[u - 1])
        pending += 1
        if pending == chunk:
            acc.remainder_(p)
            pending = 0
    return _into(acc.remainder_(p).to(torch.int32), out)


def gf_axpy_ref(y: torch.Tensor, alpha: int, x: torch.Tensor,
                p: int) -> torch.Tensor:
    """(y + alpha * x) mod p — the regenerate-path primitive."""
    require_int32_envelope(p)
    return torch.remainder(_reduced(y, p) + (int(alpha) % p) * _reduced(x, p),
                           p).to(torch.int32)


__all__ = ["gf_matmul_ref", "circulant_encode_ref", "gf_axpy_ref",
           "matmul_sources", "row_layout", "MAX_SOURCES"]
