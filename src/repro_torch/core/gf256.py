"""GF(2^8), the byte-native field (the port of ``repro.core.gf256``).

The primary field is GF(257); GF(2^8) is closed over bytes (no 256-value
packing, XOR addition) at the price of table gathers instead of exact
fp32 matmuls.  Field: AES polynomial x^8+x^4+x^3+x+1 (0x11B), generator
0x03.

Provided: elementwise ops, matmul, Gauss-Jordan inverse -- enough to run a
Vandermonde/Cauchy MDS code over GF(256).  The elementwise ops and
``matmul`` are torch ops with int32 results (the reference's dtype) on
the device of their first tensor operand; operands that are all ints or
numpy arrays go to ``device`` (None: the card, as every entry point of
the port; pass ``device="cpu"`` for the host).  ``gauss_inverse`` is host
numpy, as in the reference.  Bit-identical to the reference on every
input.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.device import resolve_device

_POLY = 0x11B
_GEN = 0x03


@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """exp[i] = g^i (510 entries for wraparound), log[x] for x in 1..255."""
    exp = np.zeros(510, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        hi = x << 1                  # times generator 0x03 = (x << 1) ^ x
        if hi & 0x100:
            hi ^= _POLY
        x = hi ^ x
    exp[255:510] = exp[0:255]
    return exp, log


@functools.cache
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    exp, log = _tables()
    return (torch.from_numpy(exp).to(device),
            torch.from_numpy(log).to(device))


def _device(*xs, device=None) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def _as_int32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def add(x, y, *, device=None) -> torch.Tensor:
    """Addition in GF(2^8) is XOR."""
    dev = _device(x, y, device=device)
    return torch.bitwise_xor(_as_int32(x, dev), _as_int32(y, dev))


sub = add  # characteristic 2


def mul(x, y, *, device=None) -> torch.Tensor:
    dev = _device(x, y, device=device)
    exp_t, log_t = _device_tables(dev)
    x, y = _as_int32(x, dev), _as_int32(y, dev)
    prod = exp_t[log_t[x.long()] + log_t[y.long()]]
    return torch.where((x == 0) | (y == 0), 0, prod).to(torch.int32)


def inv(x, *, device=None) -> torch.Tensor:
    dev = _device(x, device=device)
    exp_t, log_t = _device_tables(dev)
    x = _as_int32(x, dev)
    return torch.where(x == 0, 0, exp_t[255 - log_t[x.long()]]).to(
        torch.int32)


def matmul(a, b, *, device=None) -> torch.Tensor:
    """(a @ b) over GF(2^8): gather-multiply, then an XOR reduce over k.

    a: (m, k), b: (k, n) bytes.  The (m, k, n) products are formed at
    once, as in the reference; torch has no XOR reduction, so the k
    slices are folded pairwise (a tree of ``bitwise_xor``, XOR being
    associative and commutative the result is the reference's)."""
    dev = _device(a, b, device=device)
    a, b = _as_int32(a, dev), _as_int32(b, dev)
    prods = mul(a[:, :, None], b[None, :, :])        # (m, k, n)
    while prods.shape[1] > 1:
        k = prods.shape[1]
        half = k // 2
        folded = torch.bitwise_xor(prods[:, :half], prods[:, half:2 * half])
        prods = (torch.cat([folded, prods[:, 2 * half:]], dim=1)
                 if k % 2 else folded)
    if prods.shape[1] == 0:
        return torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                           device=dev)
    return prods[:, 0]


def gauss_inverse(mat: np.ndarray) -> np.ndarray:
    """Inverse over GF(2^8), host-side numpy."""
    exp, log = _tables()

    def m_(x, y):
        if x == 0 or y == 0:
            return 0
        return int(exp[log[x] + log[y]])

    def inv_(x):
        return int(exp[255 - log[x]]) if x else 0

    if isinstance(mat, torch.Tensor):
        mat = mat.cpu().numpy()
    mat = np.asarray(mat, np.int32) % 256
    n = mat.shape[0]
    aug = np.concatenate([mat, np.eye(n, dtype=np.int32)], axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col]), None)
        if piv is None:
            raise ValueError("singular over GF(256)")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        pinv = inv_(int(aug[col, col]))
        aug[col] = [m_(int(v), pinv) for v in aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                f = int(aug[r, col])
                aug[r] = [int(v) ^ m_(f, int(w))
                          for v, w in zip(aug[r], aug[col])]
    return aug[:, n:].astype(np.int32)


__all__ = ["add", "sub", "mul", "inv", "matmul", "gauss_inverse"]
