"""GF(p) matrix multiply (a @ b) mod p — the Hopper kernel's wrapper.

The port of ``repro.kernels.gf_matmul.gf_matmul`` (a Pallas TPU kernel).
The CUDA kernel is ``csrc/gf_matmul.cu``: integer lanes with the int32
lazy-fold schedule, so it is exact for every p <= 46341 (the TPU's fp32
schedule stops at 4097), and one pass over the stream for every m <= 64.
It takes a batch axis: ``a`` shared by every batch element (one repair
matrix for F failed nodes) or one per element.

The contraction operand ``b`` is one tensor or a tuple of up to four row
sources, read by the kernel as if concatenated along the contraction
axis: a decode hands it the data and redundancy downloads where they
lie, and the fused regenerate its r_prev row beside the k helper rows,
with no concatenated copy.

Every stream operand, and the output, takes a row pitch: a column window
of a larger tensor (unit stride along the stream, any pitch between
rows, ``ref.row_layout``) is read or written where it lies.  A shard of
a stream-axis mesh reads its window of the operands and writes its
window of the output (``out=``) with no copy.

On a CUDA tensor the wrapper launches the kernel and raises if the launch
fails; on a CPU tensor it runs the plain version, ``ref.gf_matmul_ref``.
There is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .envelope import int32_lazy_terms, require_int32_envelope
from .ref import gf_matmul_ref, matmul_sources, row_layout

# gf_matmul_launch(a, out, src, bstride, ld, rows, nsrc, batch, m, k, s,
#                  a_bstride, out_ld, out_bstride, p, lazy, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p,
             ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_longlong),
             ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _entry(name: str, argtypes: list):
    """A C entry of the built library with its signature set (once)."""
    lib = _build.load("gf_matmul")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _check(a, sources: tuple, p: int) -> None:
    require_int32_envelope(p)
    named = (("a", a),) + tuple((f"b[{i}]" if len(sources) > 1 else "b", x)
                                for i, x in enumerate(sources))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t is a and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"a on {a.device}, {name} on {t.device}")
        if t is not a:
            row_layout(t, name)
    shapes = [tuple(x.shape) for x in sources]
    dims = {x.dim() for x in sources}
    if a.dim() not in (2, 3) or len(dims) != 1 or not dims <= {2, 3} or \
            (a.dim() == 3 and dims != {3}):
        raise ValueError(f"need a (m, k) or (F, m, k) and b (k, s) or "
                         f"(F, k, s), got {tuple(a.shape)} @ {shapes}")
    if len({x.shape[-1] for x in sources}) != 1:
        raise ValueError(f"row sources differ in stream length: {shapes}")
    if dims == {3} and len({x.shape[0] for x in sources}) != 1:
        raise ValueError(f"row sources differ in batch: {shapes}")
    if a.dim() == 3 and a.shape[0] != sources[0].shape[0]:
        raise ValueError(f"batch mismatch: {tuple(a.shape)} @ {shapes}")
    if a.shape[-1] != sum(x.shape[-2] for x in sources):
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{shapes}")


def gf_matmul(a: torch.Tensor, b, p: int = 257, out=None) -> torch.Tensor:
    """(a @ b) mod p, exact.

    a: (m, k) or (F, m, k) int32, contiguous.  b: (k, s) or (F, k, s)
    int32, or a tuple of 1-4 row sources (r_i, s) or (F, r_i, s) with
    equal s (and F) and sum(r_i) = k; the result is bit-identical to
    passing ``torch.cat(b, dim=-2)``.  Each source may be a column window
    (``ref.row_layout``); every tensor on one device.  Returns (m, s) or
    (F, m, s) int32, written into ``out`` (a window of that shape, which
    must not overlap itself) when given.  Inputs need not be reduced mod
    p.
    """
    sources = matmul_sources(b)
    _check(a, sources, p)
    if a.device.type == "cpu":
        return gf_matmul_ref(a, sources, p, out=out)
    if a.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu, not {a.device}")
    if p < 2:
        raise ValueError(f"the CUDA kernel needs p >= 2, got {p}")
    head = sources[0]
    batched = head.dim() == 3
    f = head.shape[0] if batched else 1
    m, k = a.shape[-2], a.shape[-1]
    s = head.shape[-1]
    shape = ((f,) if batched else ()) + (m, s)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    elif tuple(out.shape) != shape or out.dtype != torch.int32 or \
            out.device != a.device:
        raise ValueError(f"out must be int32 {shape} on {a.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    out_ld, out_bstride = row_layout(out, "out", out=True)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    sources = [x for x in sources if x.shape[-2] > 0]
    n = len(sources)
    layouts = [row_layout(x, "b") for x in sources]
    ptrs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in sources])
    rows = (ctypes.c_int * n)(*[x.shape[-2] for x in sources])
    lds = (ctypes.c_longlong * n)(*[ld for ld, _ in layouts])
    bstrides = (ctypes.c_longlong * n)(
        *[bs if batched else 0 for _, bs in layouts])
    lib, fn = _entry("gf_matmul_launch", _ARGTYPES)
    a_bstride = m * k if a.dim() == 3 else 0
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), out.data_ptr(), ptrs, bstrides, lds, rows, n,
                 f, m, k, s, a_bstride, out_ld,
                 out_bstride if batched else 0, p, int32_lazy_terms(p),
                 stream)
    _build.check(lib, err, "gf_matmul")
    gf_matmul.launches += 1
    return out


gf_matmul.launches = 0


def fold_mismatches(p: int, device="cuda") -> int:
    """How many uint32 values x the kernel's Barrett fold maps to something
    other than x % p: an exhaustive check of all 2^32 values on the card
    (0 means the fold is exact for every accumulator a launch can hold).
    Synchronises."""
    require_int32_envelope(p)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the fold check runs on the card, not {dev}")
    if p < 2:
        raise ValueError(f"the CUDA kernel needs p >= 2, got {p}")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    lib, fn = _entry("gf_fold_check_launch",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p, bad.data_ptr(), stream)
    _build.check(lib, err, "gf_fold_check")
    return int(bad.item())


__all__ = ["gf_matmul", "fold_mismatches"]
