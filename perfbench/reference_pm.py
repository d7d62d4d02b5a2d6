"""Plain reference of the product-matrix MSR code of Rashmi, Shah and
Kumar (arXiv:1005.4178, the PM-MSR construction for d >= 2k - 2),
written from the paper and independent of the program under test.

Construction (paper §IV, with the shortening of §IV-D for d > 2k - 2):

* alpha = d - k + 1 blocks a node, B = k alpha payload blocks a stripe.
* A parent code of n' = n + i nodes, i = d - 2k + 2, and d' = 2 alpha:
  node j of the parent stores w_j = psi_j^T M, with psi_j = (1, g_j,
  ..., g_j^(2 alpha - 1)) and M = [S1; S2] two symmetric alpha x alpha
  message matrices (alpha (alpha + 1) free symbols).  The evaluation
  points g_j are the configuration's, as the double-circulant code's
  coefficients c are: the first n are the real nodes, the last i the
  virtual ones.  They must be distinct and nonzero with distinct
  lambda_j = g_j^alpha; this module checks that and picks none.
* Shortening: the messages whose i virtual shares vanish, a space of
  dimension B.  Its systematic generator on nodes 1..k (the (n alpha,
  B) matrix whose first B rows are the identity) is unique for the
  code, so no basis choice shows in it; found here by GF(p)
  elimination in Python integers.
* Repair of node f from any d helpers H: helper h sends psi_h^T M phi_f
  (its share times phi_f, the first alpha entries of psi_f); with the
  i virtual (zero) sends, Psi_sys = [psi_h; psi_virtual] is invertible
  and Psi_sys M phi_f = [sends; 0].  By the symmetry of S1 and S2,
  w_f = [I | lambda_f I] M phi_f.

Payload layout: byte b is symbol b; stripe t carries blocks m = 0..B-1
of S symbols, and block m is block m mod alpha of node m // alpha + 1
(``data_location``).  ``symbol_bits`` holds every result in that many
bits, as in ``reference.py``: the control.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import torch

from .reference import gf_matmul


@dataclasses.dataclass(frozen=True)
class Code:
    """A product-matrix (n, k, d) code over GF(p) with its points."""
    n: int
    k: int
    d: int
    p: int
    g: tuple[int, ...]              # n + i evaluation points
    gen: tuple[tuple[int, ...], ...]  # (n alpha, B) systematic generator

    @property
    def alpha(self) -> int:
        return self.d - self.k + 1

    @property
    def data_blocks(self) -> int:
        return self.k * self.alpha

    def psi(self, j: int) -> list[int]:
        """psi_j of the parent's node j (1-indexed; > n is virtual)."""
        g = self.g[j - 1]
        return [pow(g, e, self.p) for e in range(2 * self.alpha)]


# ------------------------------------------------------------ GF(p) algebra
def _rref(rows: list[list[int]], p: int) -> tuple[list[list[int]], list]:
    """Reduced row echelon form mod p and its pivot columns."""
    m = [[x % p for x in r] for r in rows]
    pivots, r = [], 0
    cols = len(m[0]) if m else 0
    for c in range(cols):
        piv = next((i for i in range(r, len(m)) if m[i][c]), None)
        if piv is None:
            continue
        m[r], m[piv] = m[piv], m[r]
        inv = pow(m[r][c], p - 2, p)
        m[r] = [x * inv % p for x in m[r]]
        for i in range(len(m)):
            if i != r and m[i][c]:
                f = m[i][c]
                m[i] = [(x - f * y) % p for x, y in zip(m[i], m[r])]
        pivots.append(c)
        r += 1
    return m[:r], pivots


def _nullspace(rows: list[list[int]], cols: int, p: int) -> list[list[int]]:
    """A basis of {x : rows x = 0}, as the columns of a (cols, dim)
    matrix."""
    red, pivots = _rref(rows, p) if rows else ([], [])
    free = [c for c in range(cols) if c not in pivots]
    basis = []
    for f in free:
        x = [0] * cols
        x[f] = 1
        for r, c in enumerate(pivots):
            x[c] = -red[r][f] % p
        basis.append(x)
    return [list(col) for col in zip(*basis)]


def _inverse(a: list[list[int]], p: int) -> list[list[int]]:
    size = len(a)
    aug = [list(r) + [int(i == j) for j in range(size)]
           for i, r in enumerate(a)]
    red, pivots = _rref(aug, p)
    if pivots[:size] != list(range(size)):
        raise ValueError("matrix is singular over GF(p)")
    return [r[size:] for r in red]


def _mul(a: list[list[int]], b: list[list[int]], p: int) -> list[list[int]]:
    bt = list(zip(*b))
    return [[sum(x * y for x, y in zip(r, c)) % p for c in bt] for r in a]


# -------------------------------------------------------------- the code
@functools.lru_cache(maxsize=None)
def make(n: int, k: int, d: int, p: int, g: tuple[int, ...]) -> Code:
    """The code (n, k, d) over GF(p) on the stated points ``g``."""
    if k < 2 or not 2 * k - 2 <= d <= n - 1:
        raise ValueError(f"product-matrix MSR needs k >= 2 and 2k-2 <= d "
                         f"<= n-1, got (n, k, d) = ({n}, {k}, {d})")
    alpha, i = d - k + 1, d - 2 * k + 2
    g = tuple(int(x) % p for x in g)
    if len(g) != n + i:
        raise ValueError(f"need n + i = {n + i} points, got {len(g)}")
    lams = [pow(x, alpha, p) for x in g]
    if 0 in g or len(set(g)) != len(g) or len(set(lams)) != len(lams):
        raise ValueError("points must be distinct and nonzero, with "
                         f"distinct {alpha}-th powers")
    # the free symbols of two symmetric alpha x alpha matrices
    var = {}
    for s in range(2):
        for u in range(alpha):
            for v in range(u, alpha):
                var[s, u, v] = len(var)
    b_parent = len(var)

    def share_rows(j: int) -> list[list[int]]:
        # w_j[t] = sum_r psi_j[r] M[r][t], M[s alpha + u][t] = S_s[u][t]
        psi = [pow(g[j], e, p) for e in range(2 * alpha)]
        rows = []
        for t in range(alpha):
            row = [0] * b_parent
            for s in range(2):
                for u in range(alpha):
                    x = var[s, min(u, t), max(u, t)]
                    row[x] = (row[x] + psi[s * alpha + u]) % p
            rows.append(row)
        return rows

    real = [r for j in range(n) for r in share_rows(j)]
    virtual = [r for j in range(n, n + i) for r in share_rows(j)]
    basis = _nullspace(virtual, b_parent, p) if virtual else \
        [[int(a == b) for b in range(b_parent)] for a in range(b_parent)]
    if len(basis[0]) != k * alpha:
        raise AssertionError(f"shortened code has dimension "
                             f"{len(basis[0])}, not {k * alpha}")
    on_real = _mul(real, basis, p)              # (n alpha, B)
    gen = _mul(on_real, _inverse(on_real[:k * alpha], p), p)
    return Code(n, k, d, p, g, tuple(tuple(r) for r in gen))


def data_location(code: Code, m: int) -> tuple[int, int]:
    """Payload block m of a stripe: (code node, block of its share)."""
    return m // code.alpha + 1, m % code.alpha


def _tensor(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=like.device)


def encode(code: Code, data: torch.Tensor,
           symbol_bits: Optional[int] = None) -> torch.Tensor:
    """(..., B, S) payload blocks -> (..., n, alpha, S) shares."""
    if data.shape[-2] != code.data_blocks:
        raise ValueError(f"need {code.data_blocks} data blocks, got "
                         f"{data.shape[-2]}")
    out = gf_matmul(_tensor(code.gen, data), data, code.p, symbol_bits)
    return out.reshape(*data.shape[:-2], code.n, code.alpha, data.shape[-1])


def helpers(code: Code, node: int) -> tuple[int, ...]:
    """The d code nodes after ``node``, cyclically: the helpers the
    check regenerates ``node`` from (any d would do)."""
    return tuple((node - 1 + t) % code.n + 1 for t in range(1, code.d + 1))


def send(code: Code, node: int, share: torch.Tensor) -> torch.Tensor:
    """A helper's (..., alpha, S) share -> its (..., S) send to ``node``:
    the share times phi_node."""
    phi = _tensor([code.psi(node)[:code.alpha]], share)
    return gf_matmul(phi, share, code.p)[..., 0, :]


def regenerate(code: Code, node: int, helper_nodes: Sequence[int],
               sends: torch.Tensor, symbol_bits: Optional[int] = None,
               ) -> torch.Tensor:
    """Node ``node``'s (..., alpha, S) share from the (..., d, S) sends of
    ``helper_nodes`` (d distinct nodes other than ``node``)."""
    hs = [int(h) for h in helper_nodes]
    if len(set(hs)) != code.d or node in hs:
        raise ValueError(f"need {code.d} distinct helpers other than "
                         f"{node}, got {hs}")
    a, p = code.alpha, code.p
    virtual = range(code.n + 1, len(code.g) + 1)
    psi_inv = _inverse([code.psi(j) for j in hs + list(virtual)], p)
    lam = pow(code.g[node - 1], a, p)
    lift = [[int(c == r) + lam * int(c == r + a) for c in range(2 * a)]
            for r in range(a)]
    rep = [row[:code.d] for row in _mul(lift, psi_inv, p)]
    return gf_matmul(_tensor(rep, sends), sends, p, symbol_bits)


__all__ = ["Code", "make", "data_location", "encode", "helpers", "send",
           "regenerate"]
