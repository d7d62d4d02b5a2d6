"""Double circulant generator machinery (paper §III-A, §III-B, §IV-A) —
the port of ``repro.core.circulant``, host numpy, copied line for line so
the seeded coefficient search gives the same ``c`` for every (k, p).

The code is generated by A = (I | M) with M the n x n circulant matrix of
the vector  w = circ(0_1, ..., 0_k, c_1, ..., c_k),  n = 2k:

    M[j, i] = w[(i - j) mod n]          (row j = coefficient of a_j,
                                         column i = redundancy of node v_{i+1})

so the redundancy block of node v_i (1-indexed) is

    r_i = sum_{u=1..k} c_u * a_{(i - k - u) mod n}        (eq. (2) realised)

Data-reconstruction validity is condition (6):  for every k-subset s of the
nodes,  det(M^s_sbar) != 0  over F_p (Corollary 3).  This module builds M,
checks condition (6) (exhaustively for small n, by sampling for large n),
and searches valid coefficient vectors c.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from . import gf


def circulant_vector(c: Sequence[int], n: int | None = None) -> np.ndarray:
    """w = (0,...,0_k, c_1,...,c_k) of length n = 2k."""
    c = np.asarray(c, dtype=np.int64)
    k = c.shape[0]
    n = n or 2 * k
    if n != 2 * k:
        raise ValueError(f"double circulant requires n=2k, got n={n}, k={k}")
    w = np.zeros(n, dtype=np.int64)
    w[k:] = c
    return w


def circulant_matrix(c: Sequence[int], p: int = gf.DEFAULT_P) -> np.ndarray:
    """M[j, i] = w[(i - j) mod n]  (paper eq. (4), row-shifted circulant)."""
    w = circulant_vector(c) % p
    n = w.shape[0]
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return w[(i - j) % n].astype(np.int32)


def generator_matrix(c: Sequence[int], p: int = gf.DEFAULT_P) -> np.ndarray:
    """A = (I | M), n x 2n.  Node v_i <-> columns (2(i-1), 2(i-1)+1) after the
    interleaved view; here we keep the paper's (I | M) block view and provide
    `node_columns` for the interleaved per-node indexing."""
    m = circulant_matrix(c, p)
    n = m.shape[0]
    return np.concatenate([np.eye(n, dtype=np.int32), m], axis=1)


def node_columns(i: int, n: int) -> tuple[int, int]:
    """Columns of A = (I|M) held by node v_i (1-indexed): (data, redundancy)."""
    if not 1 <= i <= n:
        raise ValueError(f"node index {i} out of range 1..{n}")
    return (i - 1, n + i - 1)


def redundancy_support(i: int, n: int) -> list[int]:
    """Data-block indices (0-based) appearing in r_i, in coefficient order:
    r_i = sum_u c_u * a[(i - k - u) mod n],  u = 1..k."""
    k = n // 2
    return [(i - k - u) % n for u in range(1, k + 1)]


def submatrix_condition_det(c: Sequence[int], s: Sequence[int],
                            p: int = gf.DEFAULT_P) -> int:
    """det(M^s_sbar) over GF(p) for the k-subset s (1-indexed node ids)."""
    m = circulant_matrix(c, p)
    n = m.shape[0]
    s0 = sorted(x - 1 for x in s)
    sbar = sorted(set(range(n)) - set(s0))
    return gf.gauss_det(m[np.ix_(sbar, s0)], p)


def check_condition6(c: Sequence[int], p: int = gf.DEFAULT_P,
                     *, max_exhaustive: int = 14,
                     samples: int = 2000, seed: int = 0) -> bool:
    """Condition (6): prod over all k-subsets s of det(M^s_sbar) != 0.

    Exhaustive for n <= max_exhaustive (C(n, k) subsets); Monte-Carlo sampled
    beyond that (a failure certificate is exact either way; a pass for large
    n is probabilistic, which we record in benchmarks).
    """
    c = list(int(x) % p for x in c)
    if any(x == 0 for x in c):
        return False  # paper requires c_i != 0
    k = len(c)
    n = 2 * k
    m = circulant_matrix(c, p)
    full = set(range(n))

    def det_ok(s0: tuple[int, ...]) -> bool:
        sbar = sorted(full - set(s0))
        return gf.gauss_det(m[np.ix_(sbar, list(s0))], p) != 0

    if n <= max_exhaustive:
        return all(det_ok(s0) for s0 in itertools.combinations(range(n), k))
    rng = np.random.default_rng(seed)
    seen: set[tuple[int, ...]] = set()
    # always include the structurally extreme subsets
    for s0 in ([*range(k)], [*range(k, n)], [*range(0, n, 2)], [*range(1, n, 2)]):
        if not det_ok(tuple(s0)):
            return False
    for _ in range(samples):
        s0 = tuple(sorted(rng.choice(n, size=k, replace=False).tolist()))
        if s0 in seen:
            continue
        seen.add(s0)
        if not det_ok(s0):
            return False
    return True


def find_coefficients(k: int, p: int = gf.DEFAULT_P, *,
                      max_trials: int = 4000, seed: int = 0,
                      max_exhaustive: int = 14,
                      samples: int = 400) -> np.ndarray:
    """Search a coefficient vector c (len k, entries in [1, p)) satisfying
    condition (6).  Tries the paper's style of small vectors first, then
    random ones (Schwartz–Zippel: random c succeeds w.h.p. for p >> n)."""
    rng = np.random.default_rng(seed)
    candidates: Iterable[Sequence[int]] = []
    small: list[Sequence[int]] = []
    if p > 2:
        small.append([1] * k)
        small.append([1] * (k - 1) + [2] if k >= 2 else [1])
        small.append([(i % (p - 1)) + 1 for i in range(k)])
    else:
        small.append([1] * k)
    tried = 0
    for c in small:
        tried += 1
        if check_condition6(c, p, max_exhaustive=max_exhaustive, samples=samples):
            return np.asarray(c, dtype=np.int32)
    while tried < max_trials:
        tried += 1
        c = rng.integers(1, p, size=k).tolist()
        if check_condition6(c, p, max_exhaustive=max_exhaustive, samples=samples):
            return np.asarray(c, dtype=np.int32)
    raise ValueError(f"no valid coefficients found for [n={2*k},k={k}] over GF({p}) "
                     f"after {max_trials} trials")


def min_field_size(k: int, *, prime_fields: Sequence[int] = (2, 3, 5, 7, 11, 13),
                   max_trials: int = 2000) -> int:
    """Smallest prime p from `prime_fields` admitting a valid double circulant
    MSR code (paper §IV-A).  Exhausts ALL (p-1)^k coefficient vectors for tiny
    search spaces, falls back to randomized search otherwise."""
    for p in prime_fields:
        space = (p - 1) ** k
        if space <= max_trials:
            for c in itertools.product(range(1, p), repeat=k):
                if check_condition6(c, p):
                    return p
        else:
            try:
                find_coefficients(k, p, max_trials=max_trials)
                return p
            except ValueError:
                pass
    raise ValueError(f"no field in {prime_fields} admits a [{2*k},{k}] code")


@dataclass(frozen=True)
class CodeSpec:
    """A validated double circulant MSR code specification."""
    k: int
    p: int
    c: tuple[int, ...]

    @property
    def n(self) -> int:
        return 2 * self.k

    @property
    def d(self) -> int:
        return self.k + 1

    def matrix_m(self) -> np.ndarray:
        return circulant_matrix(self.c, self.p)

    def matrix_a(self) -> np.ndarray:
        return generator_matrix(self.c, self.p)

    @staticmethod
    def make(k: int, p: int = gf.DEFAULT_P, c: Sequence[int] | None = None,
             *, validate: bool = True, seed: int = 0) -> "CodeSpec":
        """Memoized: the coefficient search + condition-(6) validation is
        O(C(n,k)) determinant work, and tests/benchmarks request the same
        (k, p) dozens of times.  CodeSpec is frozen, so sharing is safe."""
        c = None if c is None else tuple(int(x) % p for x in c)
        return CodeSpec._make_cached(k, p, c, validate, seed)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _make_cached(k: int, p: int, c: tuple[int, ...] | None,
                       validate: bool, seed: int) -> "CodeSpec":
        if c is None:
            # the search's Monte-Carlo screen is lighter than the final
            # validation below; retry fresh seeds if a candidate slips through
            last_err = None
            for attempt in range(8):
                cand = find_coefficients(k, p, seed=seed + 1000 * attempt)
                cand = tuple(int(x) % p for x in cand)
                if not validate or check_condition6(cand, p):
                    return CodeSpec(k=k, p=p, c=cand)
                last_err = cand
            raise ValueError(f"no validated coefficients for [{2*k},{k}] over "
                             f"GF({p}); last candidate {last_err}")
        if validate and not check_condition6(c, p):
            raise ValueError(f"coefficients {c} violate condition (6) over GF({p})")
        return CodeSpec(k=k, p=p, c=c)


__all__ = [
    "circulant_vector", "circulant_matrix", "generator_matrix", "node_columns",
    "redundancy_support", "submatrix_condition_det", "check_condition6",
    "find_coefficients", "min_field_size", "CodeSpec",
]
