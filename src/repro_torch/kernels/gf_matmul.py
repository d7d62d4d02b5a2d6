"""GF(p) matrix multiply (a @ b) mod p — the Hopper kernel's wrapper.

The port of ``repro.kernels.gf_matmul.gf_matmul`` (a Pallas TPU kernel).
The CUDA kernel is ``csrc/gf_matmul.cu``: integer lanes with the int32
lazy-fold schedule, so it is exact for every p <= 46341 (the TPU's fp32
schedule stops at 4097).  It takes a batch axis: ``a`` shared by every
batch element (one repair matrix for F failed nodes) or one per element.

On a CUDA tensor the wrapper launches the kernel and raises if the launch
fails; on a CPU tensor it runs the plain version, ``ref.gf_matmul_ref``.
There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .envelope import int32_lazy_terms, require_int32_envelope
from .ref import gf_matmul_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(a, b, p: int) -> None:
    require_int32_envelope(p)
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or \
            (a.dim() == 3 and b.dim() != 3):
        raise ValueError(f"need a (m, k) or (F, m, k) and b (k, s) or "
                         f"(F, k, s), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dim() == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def gf_matmul(a: torch.Tensor, b: torch.Tensor, p: int = 257) -> torch.Tensor:
    """(a @ b) mod p, exact.

    a: (m, k) or (F, m, k) int32; b: (k, s) or (F, k, s) int32; both
    contiguous and on one device.  Returns (m, s) or (F, m, s) int32.
    Inputs need not be reduced mod p.
    """
    _check(a, b, p)
    if a.device.type == "cpu":
        return gf_matmul_ref(a, b, p)
    if a.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu, not {a.device}")
    batched = b.dim() == 3
    f = b.shape[0] if batched else 1
    m, k = a.shape[-2], a.shape[-1]
    s = b.shape[-1]
    out = torch.empty(((f,) if batched else ()) + (m, s), dtype=torch.int32,
                      device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    if f > 65535:
        raise ValueError(f"batch of {f} exceeds the kernel's 65535")
    lib = _build.load("gf_matmul")
    fn = lib.gf_matmul_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    a_bstride = m * k if a.dim() == 3 else 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), f, m, k, s,
                 a_bstride, k * s, p, int32_lazy_terms(p), stream)
    _build.check(lib, err, "gf_matmul")
    gf_matmul.launches += 1
    return out


gf_matmul.launches = 0

__all__ = ["gf_matmul"]
