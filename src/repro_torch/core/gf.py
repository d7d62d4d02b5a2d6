"""Prime-field GF(p) arithmetic on torch tensors (the port of
``repro.core.gf``).

p = 257 by default: the smallest prime > 2**8, so every data byte is a
field element.  Element ops use ``torch.remainder``, which has Python's
sign rule (the reference's ``%``), so ``sub`` and ``neg`` return values in
[0, p).  Non-tensor inputs go to ``device`` (None is the card).

Host-side helpers for tiny matrices (Gauss–Jordan inverse, determinant,
null space, solve) and the byte <-> symbol packing are plain numpy,
copied from the reference so the port imports nothing of it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import as_int32, device_of

DEFAULT_P = 257


def staged(name: str):
    # lazy import: the stage clock lives in repro_torch.exec.staging and
    # core carries no module-level edge into exec
    from repro_torch.exec.staging import staged as st
    return st(name)


# ---------------------------------------------------------------------------
# Elementwise ops (int64 lanes for the products; results int32, exact)
# ---------------------------------------------------------------------------

def _t(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=dev)


def add(x, y, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    dev = device_of(x, y, device=device)
    return torch.remainder(_t(x, dev) + _t(y, dev), p).to(torch.int32)


def sub(x, y, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    dev = device_of(x, y, device=device)
    return torch.remainder(_t(x, dev) - _t(y, dev), p).to(torch.int32)


def mul(x, y, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    dev = device_of(x, y, device=device)
    return torch.remainder(torch.remainder(_t(x, dev), p)
                           * torch.remainder(_t(y, dev), p), p
                           ).to(torch.int32)


def neg(x, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    dev = device_of(x, device=device)
    return torch.remainder(-_t(x, dev), p).to(torch.int32)


def pow_(x, e: int, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    """x**e mod p by square-and-multiply (e is a python int >= 0)."""
    dev = device_of(x, device=device)
    x = torch.remainder(_t(x, dev), p)
    acc = torch.ones_like(x)
    while e:
        if e & 1:
            acc = (acc * x) % p
        x = (x * x) % p
        e >>= 1
    return acc.to(torch.int32)


def inv(x, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    """Multiplicative inverse by Fermat's little theorem: x**(p-2) mod p."""
    return pow_(x, p - 2, p, device=device)


# ---------------------------------------------------------------------------
# Matmul over GF(p)
# ---------------------------------------------------------------------------

def matmul(a, b, p: int = DEFAULT_P, *, precision=None,
           device=None) -> torch.Tensor:
    """(a @ b) mod p, exact — the plain torch version (int64 multiply-adds
    folded on the int32 schedule), on any device.  The Hopper kernel is
    reached through ``repro_torch.kernels.ops.gf_matmul``.  ``precision``
    is accepted and ignored, as in the reference: integer lanes have no
    floating-point rounding to choose."""
    del precision
    from repro_torch.kernels.ref import gf_matmul_ref
    dev = device_of(a, b, device=device)
    return gf_matmul_ref(as_int32(a, p, dev), as_int32(b, p, dev), p)


def matvec(m, v, p: int = DEFAULT_P, *, device=None) -> torch.Tensor:
    dev = device_of(m, v, device=device)
    v = torch.as_tensor(v, device=dev)
    return matmul(m, v[..., None], p, device=dev)[..., 0]


# ---------------------------------------------------------------------------
# Host-side dense linear algebra (tiny matrices: code dimension n <= 512)
# ---------------------------------------------------------------------------

def gauss_inverse(mat: np.ndarray, p: int = DEFAULT_P) -> np.ndarray:
    """Inverse of a square matrix over GF(p) by Gauss-Jordan (numpy, host).

    Raises ValueError if the matrix is singular over GF(p).
    """
    mat = np.asarray(mat, dtype=np.int64) % p
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError(f"square matrix required, got {mat.shape}")
    aug = np.concatenate([mat, np.eye(n, dtype=np.int64)], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if aug[r, col] % p != 0:
                piv = r
                break
        if piv is None:
            raise ValueError("matrix is singular over GF(%d)" % p)
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        pinv = pow(int(aug[col, col]), p - 2, p)
        aug[col] = (aug[col] * pinv) % p
        for r in range(n):
            if r != col and aug[r, col] % p:
                aug[r] = (aug[r] - aug[r, col] * aug[col]) % p
    return (aug[:, n:] % p).astype(np.int32)


def gauss_det(mat: np.ndarray, p: int = DEFAULT_P) -> int:
    """Determinant over GF(p) (numpy, host)."""
    mat = np.asarray(mat, dtype=np.int64).copy() % p
    n = mat.shape[0]
    det = 1
    for col in range(n):
        piv = None
        for r in range(col, n):
            if mat[r, col] % p != 0:
                piv = r
                break
        if piv is None:
            return 0
        if piv != col:
            mat[[col, piv]] = mat[[piv, col]]
            det = (-det) % p
        det = (det * int(mat[col, col])) % p
        pinv = pow(int(mat[col, col]), p - 2, p)
        mat[col] = (mat[col] * pinv) % p
        for r in range(col + 1, n):
            if mat[r, col] % p:
                mat[r] = (mat[r] - mat[r, col] * mat[col]) % p
    return int(det % p)


def nullspace(mat: np.ndarray, p: int = DEFAULT_P) -> np.ndarray:
    """Basis of the right null space of ``mat`` over GF(p) (numpy, host).

    Returns an (n_cols, nullity) matrix N with ``mat @ N == 0 (mod p)``
    whose columns are the canonical RREF basis vectors (free column j
    gets a 1, pivot rows carry the negated reduced entries).
    """
    a = np.asarray(mat, dtype=np.int64) % p
    if a.ndim != 2:
        raise ValueError(f"matrix required, got shape {a.shape}")
    rows, cols = a.shape
    a = a.copy()
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r == rows:
            break
        piv = None
        for i in range(r, rows):
            if a[i, c] % p:
                piv = i
                break
        if piv is None:
            continue
        if piv != r:
            a[[r, piv]] = a[[piv, r]]
        a[r] = (a[r] * pow(int(a[r, c]), p - 2, p)) % p
        for i in range(rows):
            if i != r and a[i, c] % p:
                a[i] = (a[i] - a[i, c] * a[r]) % p
        pivots.append(c)
        r += 1
    free = [c for c in range(cols) if c not in pivots]
    basis = np.zeros((cols, len(free)), dtype=np.int64)
    for j, fc in enumerate(free):
        basis[fc, j] = 1
        for i, pc in enumerate(pivots):
            basis[pc, j] = (-a[i, fc]) % p
    return (basis % p).astype(np.int32)


def solve(mat: np.ndarray, rhs: np.ndarray, p: int = DEFAULT_P) -> np.ndarray:
    """Solve mat @ x = rhs over GF(p).  rhs may be a matrix of columns.

    Host-side numpy for the tiny system matrix; the big-block application
    runs on the device through the dispatched matmul.
    """
    inv_m = gauss_inverse(mat, p)
    return (inv_m.astype(np.int64) @ (np.asarray(rhs, np.int64) % p)) % p


# ---------------------------------------------------------------------------
# Byte <-> symbol packing (host numpy)
# ---------------------------------------------------------------------------

def bytes_to_symbols(data: bytes | np.ndarray, p: int = DEFAULT_P) -> np.ndarray:
    """Lossless embedding of a byte stream into GF(p) symbols (p > 256)."""
    if p <= 256:
        raise ValueError("byte embedding requires p > 256")
    arr = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    return arr.astype(np.int32)


def bytes_to_symbols_into(data: bytes | np.ndarray, out: np.ndarray,
                          p: int = DEFAULT_P) -> np.ndarray:
    """One-pass byte embedding into a preallocated flat int32 buffer; the
    tail past the payload is zeroed.  Counts toward the "pack" stage
    clock."""
    if p <= 256:
        raise ValueError("byte embedding requires p > 256")
    arr = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8)
    if out.dtype != np.int32 or out.ndim != 1 or out.size < arr.size:
        raise ValueError(f"need flat int32 out of >= {arr.size} symbols, "
                         f"got {out.dtype} {out.shape}")
    with staged("pack"):
        out[:arr.size] = arr
        out[arr.size:] = 0
    return out


def symbols_to_bytes(sym: np.ndarray) -> bytes:
    sym = np.asarray(sym)
    if sym.max(initial=0) > 255 or sym.min(initial=0) < 0:
        raise ValueError("symbols out of byte range; not a systematic data block")
    return sym.astype(np.uint8).tobytes()


def pack257(sym: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack GF(257) symbols (values 0..256) into (low_bytes uint8, idx256):
    the rare value 256 is stored by position, so redundancy blocks stay
    byte-priced."""
    sym = np.asarray(sym)
    if sym.min(initial=0) < 0 or sym.max(initial=0) > 256:
        raise ValueError("symbols out of GF(257) range")
    hi = np.nonzero(sym.reshape(-1) == 256)[0].astype(np.int64)
    low = (sym.reshape(-1) % 256).astype(np.uint8)
    return low, hi


def unpack257(low: np.ndarray, hi: np.ndarray, shape=None) -> np.ndarray:
    out = low.astype(np.int32)
    out[hi] = 256
    return out.reshape(shape) if shape is not None else out


def pack257_rows(sym: np.ndarray, *, out: np.ndarray | None = None,
                 ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Vectorized per-row pack257 for a (n, S) block matrix: the uint8 low
    bytes (n, S) and a list of n per-row index-of-256 arrays.  ``out``
    (uint8, same shape) receives the low bytes in place."""
    sym = np.asarray(sym)
    if sym.ndim != 2:
        raise ValueError(f"expected (n, S) block matrix, got {sym.shape}")
    if sym.min(initial=0) < 0 or sym.max(initial=0) > 256:
        raise ValueError("symbols out of GF(257) range")
    if out is not None and (out.shape != sym.shape
                            or out.dtype != np.uint8):
        raise ValueError(f"out must be uint8 {sym.shape}, got "
                         f"{out.dtype} {out.shape}")
    with staged("pack"):
        if out is None:
            low = (sym & 0xFF).astype(np.uint8)  # 256 -> 0, others kept
        else:
            np.copyto(out, sym, casting="unsafe")
            low = out
        rows, cols = np.nonzero(sym == 256)
        splits = np.searchsorted(rows, np.arange(1, sym.shape[0]))
        his = np.split(cols.astype(np.int64), splits)
    return low, his


def unpack257_rows(low: np.ndarray, his: Sequence[np.ndarray], *,
                   out: np.ndarray | None = None) -> np.ndarray:
    """Inverse of pack257_rows.  ``out`` (int32, same shape) receives the
    expansion in place."""
    if out is not None:
        low = np.asarray(low)
        if out.shape != low.shape or out.dtype != np.int32:
            raise ValueError(f"out must be int32 {low.shape}, got "
                             f"{out.dtype} {out.shape}")
    with staged("pack"):
        if out is None:
            out = np.asarray(low).astype(np.int32)
        else:
            np.copyto(out, low)
        for i, hi in enumerate(his):
            out[i, hi] = 256
    return out


def packed_nbytes(sym: np.ndarray) -> int:
    low, hi = pack257(sym)
    return low.nbytes + hi.nbytes


__all__ = [
    "DEFAULT_P", "add", "sub", "mul", "neg", "pow_", "inv", "matmul",
    "matvec", "gauss_inverse", "gauss_det", "nullspace", "solve",
    "bytes_to_symbols", "bytes_to_symbols_into", "symbols_to_bytes",
    "pack257", "unpack257", "pack257_rows", "unpack257_rows", "packed_nbytes",
]
