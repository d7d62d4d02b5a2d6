"""Double-circulant MSR encode (paper eq. (2)) — the Hopper kernel's wrapper.

The port of ``repro.kernels.circulant_encode.circulant_encode`` (a Pallas
TPU kernel that bakes ``c`` in per CodeSpec).  The CUDA kernel is
``csrc/circulant_encode.cu``: each column is read once into shared
memory and all n outputs are computed from it with k MACs each, the roll
done as index arithmetic; ``c`` is passed at run time (k <= 256).

On a CUDA tensor the wrapper launches the kernel and raises if the launch
fails; on a CPU tensor it runs the plain version,
``ref.circulant_encode_ref``.  There is no fallback between the two.

``data`` and ``out=`` may be column windows of larger tensors (unit
stride along the stream, any row pitch: ``ref.row_layout``); the kernel
reads and writes them where they lie.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .envelope import int32_lazy_terms, require_int32_envelope
from .ref import circulant_encode_ref, row_layout

MAX_K = 256      # the kernel's by-value coefficient struct

# circulant_encode_launch(data, out, n, s, data_ld, out_ld, c, k, p, lazy,
#                         stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def circulant_encode(data: torch.Tensor, c: Sequence[int],
                     p: int = 257, out=None) -> torch.Tensor:
    """data: (n, s) int32 data blocks (a column window is fine) -> (n, s)
    int32 redundancy blocks, n = 2 * len(c), written into ``out`` (a
    window of that shape on data's device) when given.  Inputs need not
    be reduced mod p; coefficients must be nonzero mod p."""
    require_int32_envelope(p)
    c = tuple(int(x) % p for x in c)
    if any(x == 0 for x in c):
        raise ValueError("coefficients must be nonzero (paper §III-A)")
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    if data.dtype != torch.int32:
        raise TypeError(f"data must be int32, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (n, s), got {tuple(data.shape)}")
    data_ld, _ = row_layout(data, "data")
    n, s = data.shape
    k = len(c)
    if n != 2 * k:
        raise ValueError(f"n={n} != 2k={2 * k}")
    if data.device.type == "cpu":
        return circulant_encode_ref(data, c, p, out=out)
    if data.device.type != "cuda":
        raise ValueError(f"circulant_encode runs on cuda or cpu, "
                         f"not {data.device}")
    if k > MAX_K:
        raise ValueError(f"the CUDA kernel takes k <= {MAX_K}, got k={k}")
    if out is None:
        out = torch.empty((n, s), dtype=torch.int32, device=data.device)
    elif tuple(out.shape) != (n, s) or out.dtype != torch.int32 or \
            out.device != data.device:
        raise ValueError(f"out must be int32 {(n, s)} on {data.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    out_ld, _ = row_layout(out, "out", out=True)
    if s == 0:
        return out
    lib = _build.load("circulant_encode")
    fn = lib.circulant_encode_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    coefs = (ctypes.c_int * k)(*c)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), n, s, data_ld, out_ld,
                 coefs, k, p, int32_lazy_terms(p), stream)
    _build.check(lib, err, "circulant_encode")
    circulant_encode.launches += 1
    return out


circulant_encode.launches = 0

__all__ = ["circulant_encode", "MAX_K"]
