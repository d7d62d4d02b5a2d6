"""Baselines the paper compares against (§II, §IV) — the port of
``repro.core.baselines``.  The RS code's products run through the port's
GF dispatch (the Hopper ``gf_matmul`` on the card); the cost formulas are
the reference's.

1. Replication  — per-node storage alpha = B, repair gamma = B (download a
   full replica); storage overhead = replicas x.
2. Classical MDS erasure coding (systematic Reed–Solomon via Vandermonde over
   GF(p)) — alpha = B/k, but repair of ONE node requires downloading the
   whole file: gamma = B (the paper's central drawback, §II).
3. Solve-based MSR repair (Rashmi/Cullina-style, modelled): optimal gamma but
   the newcomer must (a) pick d helpers, (b) discover/solve for coefficients
   — an O(k^3) field solve per repair plus per-helper inner products.  We
   model it as full any-k reconstruction + re-encode with an added coefficient
   solve, and count field operations so benchmarks can compare complexity
   (paper §IV "the algorithm for node regeneration is trivial").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import as_int32, device_of, resolve_device

from . import gf


# ----------------------------------------------------------------- replication
@dataclass(frozen=True)
class ReplicationScheme:
    replicas: int

    def storage_per_node_symbols(self, file_symbols: int) -> int:
        return file_symbols

    def total_storage_symbols(self, file_symbols: int) -> int:
        return self.replicas * file_symbols

    def repair_symbols(self, file_symbols: int) -> int:
        return file_symbols  # download one replica

    def max_failures(self) -> int:
        return self.replicas - 1


# ------------------------------------------------------------------ classical RS
class RSCode:
    """Systematic [n, k] Reed–Solomon (Vandermonde) over GF(p).

    Node v_i stores ONE block of B/k symbols (classical EC view, Fig. 1).
    Repairing any single node = reconstruct from k nodes = download B
    symbols.  ``device`` (None is the card) is where encode and
    reconstruct compute; tensor inputs keep their own device.
    """

    def __init__(self, n: int, k: int, p: int = gf.DEFAULT_P, *,
                 device=None):
        if n >= p:
            raise ValueError(f"RS over GF({p}) needs n < p, got n={n}")
        self.n, self.k, self.p = n, k, p
        self.device = resolve_device(device)
        # generator: G = [I | V] with V[j, i] = x_i^j (k x (n-k)); any k
        # columns of [I | V] invertible for distinct evaluation points: G
        # is built by interpolation to guarantee MDS.
        x = np.arange(1, n + 1, dtype=np.int64) % p          # n distinct points
        vand_k = np.vstack([pow_col(x[:k], j, p) for j in range(k)])   # (k, k)
        inv = gf.gauss_inverse(vand_k.T % p, p)               # interpolation
        vand_n = np.vstack([pow_col(x, j, p) for j in range(k)]).T % p  # (n, k)
        self.g = (vand_n.astype(np.int64) @ inv.astype(np.int64)) % p  # (n, k)
        # rows 0..k-1 of g form I_k => systematic
        if not np.array_equal(self.g[:k] % p,
                              np.eye(k, dtype=np.int64) % p):
            raise AssertionError("RS generator is not systematic")
        self.g = self.g.astype(np.int32)

    def _matmul(self, a: np.ndarray, blocks) -> torch.Tensor:
        from repro_torch.kernels import dispatch
        dev = device_of(blocks, device=self.device)
        be = dispatch.select(self.p, self.k, dev)
        return be.matmul(as_int32(a, self.p, dev),
                         as_int32(blocks, self.p, dev), self.p)

    def encode(self, data) -> torch.Tensor:
        """data: (k, S) -> codeword blocks (n, S); first k rows are the data."""
        return self._matmul(self.g, data)

    def reconstruct(self, node_ids: Sequence[int], blocks) -> torch.Tensor:
        """Any k node blocks -> original (k, S) data."""
        rows = [i - 1 for i in node_ids]
        sub = self.g[rows]                                   # (k, k)
        inv = gf.gauss_inverse(sub, self.p)
        return self._matmul(inv, blocks)

    def repair_symbols(self, file_symbols: int) -> int:
        return file_symbols                                   # gamma = B

    def storage_per_node_symbols(self, file_symbols: int) -> int:
        return file_symbols // self.k                         # alpha = B/k

    def total_storage_symbols(self, file_symbols: int) -> int:
        return self.n * self.storage_per_node_symbols(file_symbols)


def pow_col(x: np.ndarray, j: int, p: int) -> np.ndarray:
    out = np.ones_like(x)
    for _ in range(j):
        out = (out * x) % p
    return out


# ----------------------------------------------------- solve-based MSR (modelled)
@dataclass
class SolveBasedRepairCost:
    """Field-operation counts for one repair, for complexity comparison."""
    coefficient_solve_ops: int    # discovering/solving combination coefficients
    helper_combine_ops: int       # helpers' internal linear combinations
    newcomer_solve_ops: int       # newcomer's linear system solve
    stream_ops: int               # per-symbol multiply-accumulate work
    downloads_symbols: int


def solve_based_msr_repair_cost(k: int, block_symbols: int) -> SolveBasedRepairCost:
    """Rashmi et al. (d = k+1) style repair, modelled per §IV: helpers combine
    their q=2 blocks, the newcomer solves a (k+1)-dim system, and coefficients
    must be discovered per failure (O(k^3) solve over the field)."""
    d = k + 1
    return SolveBasedRepairCost(
        coefficient_solve_ops=2 * k**3,          # Gaussian elimination scale
        helper_combine_ops=d * 2 * block_symbols,  # each helper combines q=2 blocks
        newcomer_solve_ops=2 * d**3,
        stream_ops=d * d * block_symbols,        # applying the solved system
        downloads_symbols=d * block_symbols,
    )


def embedded_repair_cost(k: int, block_symbols: int) -> SolveBasedRepairCost:
    """The paper's embedded repair: zero coefficient discovery, zero helper-side
    combinations; the newcomer does 2k multiply-accumulates per symbol
    (k-1 MACs + 1 inverse-scale for a_{i-1}; k MACs for r_i)."""
    d = k + 1
    return SolveBasedRepairCost(
        coefficient_solve_ops=0,
        helper_combine_ops=0,
        newcomer_solve_ops=0,
        stream_ops=2 * k * block_symbols,
        downloads_symbols=d * block_symbols,
    )


# ------------------------------------------------- scenario-level accounting
def rs_scenario_repair_symbols(k: int, block_symbols: int,
                               n_failures: int) -> int:
    """RS re-download baseline for a failure scenario (DESIGN.md §9).

    Classical [n, k] erasure coding repairs EACH failed node by
    re-downloading the whole file: gamma = B = 2k * S symbols per failure
    (the paper's central drawback, §II).  The cluster simulator divides
    its measured repair traffic by this number to report the per-scenario
    bandwidth ratio.

    Parameters
    ----------
    k : int
        Code dimension (n = 2k).
    block_symbols : int
        Symbols per block (S); the file is B = 2k * S symbols.
    n_failures : int
        Number of failed nodes repaired in the scenario.

    Returns
    -------
    int
        Total symbols an RS cluster would move: ``n_failures * 2k * S``.
    """
    return n_failures * 2 * k * block_symbols


__all__ = ["ReplicationScheme", "RSCode", "SolveBasedRepairCost",
           "solve_based_msr_repair_cost", "embedded_repair_cost",
           "rs_scenario_repair_symbols"]
