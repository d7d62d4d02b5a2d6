"""Plain reference of what the store computes: the [n = 2k, k]
double-circulant MSR code over GF(p) of arXiv:1007.2401, written from
the paper and independent of the program under test.

Conventions (paper §III): an object's bytes, zero-padded, are cut into
stripes of n data blocks of S symbols; byte b is symbol b.  Node v_i
(1-indexed) of a stripe holds the pair (a_{i-1}, r_i) with

    r_i = sum_{u=1..k} c_u * a_{(i - k - u) mod n}          (eq. (2))

and a lost node v_i is rebuilt from d = k + 1 helpers: r_{i-1} from
v_{i-1} and the data blocks a_i .. a_{i+k-1} of v_{i+1} .. v_{i+k}
(§III-C).  Where a stripe's shares live is the store's choice; the
check asks the store and holds it to n distinct nodes (``verify.py``).

Everything is plain torch integer arithmetic on whatever device the
tensors live on; nothing here imports the program.  ``symbol_bits``
holds every result in that many bits (8 wraps the symbol 256 to 0):
the benchmark's control, the exact code computed one step below the
nine bits a GF(257) symbol needs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def n_stripes(size: int, n: int, s: int) -> int:
    """Stripes an object of ``size`` bytes occupies (at least one)."""
    return max(1, -(-size // (n * s)))


def chunk(payload: bytes, n: int, s: int, stripes: Optional[slice] = None,
          device="cpu") -> torch.Tensor:
    """(T, n, S) int32 data blocks of ``payload`` (zero-padded), or of
    the stripes in ``stripes`` only."""
    per = n * s
    total = n_stripes(len(payload), n, s)
    lo, hi, _ = (stripes or slice(0, total)).indices(total)
    raw = np.frombuffer(payload, np.uint8)[lo * per: hi * per]
    out = torch.zeros((hi - lo) * per, dtype=torch.int32, device=device)
    out[: raw.size] = torch.from_numpy(raw.copy()).to(device)
    return out.reshape(hi - lo, n, s)


def _hold(x: torch.Tensor, symbol_bits: Optional[int]) -> torch.Tensor:
    return x if symbol_bits is None else x & ((1 << symbol_bits) - 1)


def encode(blocks: torch.Tensor, c: Sequence[int], p: int,
           symbol_bits: Optional[int] = None) -> torch.Tensor:
    """(..., n, S) data blocks -> (..., n, S) redundancy blocks, eq. (2).
    Works in int64, so any k and p below 2**31 are exact."""
    k = len(c)
    n = 2 * k
    if blocks.shape[-2] != n:
        raise ValueError(f"need {n} data blocks, got {blocks.shape[-2]}")
    a = blocks.to(torch.int64)
    red = torch.zeros_like(a)
    for u in range(1, k + 1):
        idx = [(i - k - u) % n for i in range(1, n + 1)]
        red += int(c[u - 1]) * a[..., idx, :]
    return _hold(torch.remainder(red, p), symbol_bits).to(torch.int32)


def regenerate(node: int, r_prev: torch.Tensor, next_data: torch.Tensor,
               c: Sequence[int], p: int, symbol_bits: Optional[int] = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact regeneration of node v_``node`` (§III-C) from the helpers'
    blocks: ``r_prev`` (..., S) is r_{node-1} and ``next_data`` (..., k,
    S) holds a_{node}, ..., a_{node+k-1} (0-based block indices mod n).
    Returns (a_{node-1}, r_node)."""
    k = len(c)
    cc = [int(x) % p for x in c]
    nd = next_data.to(torch.int64)
    # r_{i-1} = c_k a_{i-1} + sum_{u<k} c_u a_{(i-1+k-u) mod n}; with the
    # helpers' order, a_{(i-1+k-u) mod n} is next_data[k-u-1]
    partial = torch.zeros_like(r_prev, dtype=torch.int64)
    for u in range(1, k):
        partial += cc[u - 1] * nd[..., k - u - 1, :]
    ck_inv = pow(cc[k - 1], p - 2, p)
    a_lost = torch.remainder((r_prev.to(torch.int64) - partial) * ck_inv, p)
    # r_i = sum_u c_u a_{(i+k-u) mod n}, the block next_data[k-u]
    r_new = torch.zeros_like(a_lost)
    for u in range(1, k + 1):
        r_new += cc[u - 1] * nd[..., k - u, :]
    r_new = torch.remainder(r_new, p)
    return (_hold(a_lost, symbol_bits).to(torch.int32),
            _hold(r_new, symbol_bits).to(torch.int32))


def helpers(node: int, n: int) -> tuple[int, tuple[int, ...]]:
    """(previous node, the k next nodes) that rebuild node v_``node``."""
    k = n // 2
    return (node - 2) % n + 1, tuple((node - 1 + t) % n + 1
                                     for t in range(1, k + 1))


def gf_matmul(a: torch.Tensor, b: torch.Tensor, p: int,
              symbol_bits: Optional[int] = None) -> torch.Tensor:
    """(a @ b) mod p for (m, k) or (F, m, k) ``a`` and (k, s) or (F, k,
    s) ``b``, exact: float64 products of reduced operands, each below
    2**53 for contractions up to 2**36 terms at p = 257."""
    if a.shape[-1] > (1 << 53) // ((p - 1) ** 2):
        raise ValueError("contraction too deep for exact float64")
    aa = torch.remainder(a.to(torch.int64), p).to(torch.float64)
    bb = torch.remainder(b.to(torch.int64), p).to(torch.float64)
    out = torch.remainder(torch.matmul(aa, bb).to(torch.int64), p)
    return _hold(out, symbol_bits).to(torch.int32)


__all__ = ["n_stripes", "chunk", "encode", "regenerate",
           "helpers", "gf_matmul"]
