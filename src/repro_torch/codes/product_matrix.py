"""Product-matrix MSR code family (the port of
``repro.codes.product_matrix``, DESIGN.md §15.2).

The Rashmi–Shah–Kumar product-matrix construction (arXiv:1005.4178)
gives an exact-repair MSR code for every ``d >= 2k - 2``; shortening the
parent code supports ``d < n - 1`` (repair from ANY d helpers, not a
fixed embedded set).  Construction, worked symbolically once per class
at build time:

* alpha = d - k + 1 blocks per node, B = k * alpha payload blocks.
* Parent code: shorten by i = d - 2k + 2 symbols — n' = n + i virtual
  nodes, d' = d + i = 2 * alpha.  Node j's share is
  ``w_j^T = psi_j^T M'`` with ``psi_j = (1, g_j, ..., g_j^{2a-1})``
  Vandermonde and ``M' = [[S1], [S2]]`` stacked symmetric alpha x alpha
  matrices (B' = alpha (alpha + 1) free entries).
* Shortening: the i virtual nodes' shares are constrained to zero;
  the admissible messages are ``vec(M') = Sym @ N @ theta`` where N is
  the GF null-space basis of the deleted share map, dim B' - i*alpha
  = k*alpha = B exactly.
* Systematic form: with A the first k nodes' share map restricted to
  the null space, ``G = P_real @ Sym @ N @ A^{-1}`` is the (n*alpha,
  k*alpha) generator whose top k*alpha rows are the identity — nodes
  1..k store the payload verbatim (systematic fast reads + conversion
  share reuse).
* Repair of node f from any d helpers H: each helper sends its share
  projected on ``phi_f`` (the first alpha Vandermonde components of
  psi_f) — a real (1, alpha) helper-side product, unlike the
  double-circulant one-hot sends.  Stacking the d sends with the i
  identically-zero virtual shares yields the invertible (2a, 2a)
  Vandermonde system ``Psi_sys x = [sends; 0]`` for
  ``x = M' phi_f``; by S1/S2 symmetry the lost share is
  ``w_f = [I | lambda_f I] x`` with ``lambda_f = g_f^alpha``, so the
  cached newcomer matrix is ``([I | lambda_f I] Psi_sys^{-1})[:, :d]``.
  gamma = d * S symbols — the MSR cut-set point.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import gf
from repro_torch.core.repair import DecodeInverseCache
from repro_torch.exec.plan import PlanResult

from .base import CodeClass, CodeRepairPlan, ErasureCode
from .registry import FAMILY_PRODUCT_MATRIX, register_family


def _pick_generators(count: int, alpha: int, p: int) -> np.ndarray:
    """Greedily pick ``count`` elements g of GF(p)* that are pairwise
    distinct AND have pairwise distinct lambda = g^alpha (alpha-th
    powers collide for composite p - 1, so sequential choice fails;
    greedy scan is exact)."""
    gens: list[int] = []
    lams: set[int] = set()
    for g in range(1, p):
        lam = pow(g, alpha, p)
        if lam in lams:
            continue
        gens.append(g)
        lams.add(lam)
        if len(gens) == count:
            return np.array(gens, dtype=np.int64)
    raise ValueError(f"field GF({p}) too small for {count} product-matrix "
                     f"nodes with distinct {alpha}-th powers")


def _sym_embedding(alpha: int) -> np.ndarray:
    """(2*alpha^2, B') 0/1 map from the B' = alpha*(alpha+1) free
    entries of two symmetric alpha x alpha matrices to the row-major
    flattening of M' = [[S1], [S2]]."""
    b_prime = alpha * (alpha + 1)
    sym = np.zeros((2 * alpha * alpha, b_prime), dtype=np.int64)
    col = 0
    for s in range(2):
        for u in range(alpha):
            for v in range(u, alpha):
                sym[(s * alpha + u) * alpha + v, col] = 1
                if u != v:
                    sym[(s * alpha + v) * alpha + u, col] = 1
                col += 1
    if col != b_prime:
        raise AssertionError(f"{col} free entries, expected {b_prime}")
    return sym


@register_family(FAMILY_PRODUCT_MATRIX)
class ProductMatrixMSR(ErasureCode):
    """Product-matrix MSR [n, k, d] over GF(p), 2k - 2 <= d <= n - 1.

    Unlike the double-circulant family this repairs from *any* d
    helpers, trading helper-side field ops and a denser generator for
    placement freedom and the full (n, k, d) grid.
    """

    def __init__(self, code_class: CodeClass, *, backend: Optional[str] = None,
                 mesh=None, device=None):
        if code_class.k < 2:
            raise ValueError("product-matrix MSR needs k >= 2")
        if code_class.d < 2 * code_class.k - 2:
            raise ValueError(
                f"product-matrix MSR needs d >= 2k-2, got d={code_class.d} "
                f"for k={code_class.k}")
        super().__init__(code_class, backend=backend, mesh=mesh,
                         device=device)
        n, k, d, p = self.n, self.k, self.d, self.p
        self.alpha = alpha = d - k + 1
        shortening = d - 2 * k + 2          # i >= 0
        n_parent = n + shortening
        self.B = k * alpha

        self.gens = _pick_generators(n_parent, alpha, p)
        self.lams = np.array([pow(int(g), alpha, p) for g in self.gens],
                             dtype=np.int64)
        # Psi' rows (1, g, ..., g^{2a-1}); Phi' = first alpha columns
        exps = np.arange(2 * alpha, dtype=np.int64)
        self.psi = np.stack([[pow(int(g), int(e), p) for e in exps]
                             for g in self.gens]).astype(np.int64)

        sym = _sym_embedding(alpha)
        # P: share map from vec(M') to the n' * alpha stacked share rows
        pmat = np.zeros((n_parent * alpha, 2 * alpha * alpha), dtype=np.int64)
        for j in range(n_parent):
            for t in range(alpha):
                for r in range(2 * alpha):
                    pmat[j * alpha + t, r * alpha + t] = self.psi[j, r]
        # shorten: deleted (virtual) nodes' shares must vanish
        constraints = (pmat[n * alpha:] @ sym) % p
        nsp = gf.nullspace(constraints, p).astype(np.int64)
        if nsp.shape[1] != self.B:
            raise AssertionError(
                f"shortening null space has dim {nsp.shape[1]}, "
                f"expected B = {self.B}")
        embed = (sym @ nsp) % p             # vec(M') = embed @ theta
        shares_of_theta = (pmat[:n * alpha] @ embed) % p
        a_mat = shares_of_theta[:self.B]    # first k nodes' shares
        a_inv = gf.gauss_inverse(a_mat, p).astype(np.int64)
        self.G = ((shares_of_theta @ a_inv) % p).astype(np.int64)
        if not np.array_equal(self.G[:self.B],
                              np.eye(self.B, dtype=np.int64)):
            raise AssertionError("generator is not systematic")
        self._g_parity = np.ascontiguousarray(self.G[self.B:])

        self._inverse_cache = DecodeInverseCache(
            maxsize=128, family=self.family_key(),
            matrix_fn=self._subset_matrix, k=k, p=p)
        self._newcomer_cache: dict[tuple, np.ndarray] = {}

    def _subset_matrix(self, subset: tuple[int, ...]) -> np.ndarray:
        """Node-major G rows of a k-subset — square (B, B), invertible
        by the RSK reconstruction theorem."""
        rows = [(j - 1) * self.alpha + t for j in subset
                for t in range(self.alpha)]
        return self.G[rows]

    # ------------------------------------------------------------- geometry
    @property
    def share_blocks(self) -> int:
        return self.alpha

    @property
    def data_blocks(self) -> int:
        return self.B

    @property
    def derived_rows(self) -> int:
        return (self.n - self.k) * self.alpha

    def data_location(self, m: int) -> tuple[int, int]:
        return m // self.alpha + 1, m % self.alpha

    # --------------------------------------------------------------- encode
    def encode_derived_planned(self, flat: np.ndarray) -> PlanResult:
        return self.apply_planned(self._g_parity, flat)

    def stripe_share_blocks(self, data: np.ndarray, derived: np.ndarray,
                            node: int) -> list:
        a = self.alpha
        src = data if node <= self.k else derived
        base = (node - 1) * a if node <= self.k else (node - 1 - self.k) * a
        return [src[base + t] for t in range(a)]

    # --------------------------------------------------------------- decode
    def decode_rows(self, subset: Sequence[int],
                    rows_needed: Sequence[int]) -> np.ndarray:
        inv = self._inverse_cache.inverse(tuple(subset))
        return inv[list(rows_needed)]

    def share_rows(self, subset: Sequence[int],
                   lost_nodes: Sequence[int]) -> np.ndarray:
        inv = self._inverse_cache.inverse(tuple(subset))
        a = self.alpha
        g_rows = np.concatenate([self.G[(f - 1) * a:f * a]
                                 for f in lost_nodes])
        return ((g_rows @ inv.astype(np.int64)) % self.p)

    # ----------------------------------------------------------- regenerate
    def repair_plan(self, node: int,
                    available: Optional[Sequence[int]] = None,
                    ) -> Optional[CodeRepairPlan]:
        pool = (sorted(set(available)) if available is not None
                else [j for j in range(1, self.n + 1) if j != node])
        helpers = tuple(j for j in pool if j != node)[:self.d]
        if len(helpers) < self.d:
            return None                      # any d helpers, but all d
        phi_f = self.psi[node - 1, :self.alpha].reshape(1, -1) % self.p
        send = np.ascontiguousarray(phi_f.astype(np.int32))
        return CodeRepairPlan(node=node, helpers=helpers,
                              send_matrices=(send,) * self.d,
                              blocks_downloaded=self.d)

    def newcomer_matrix(self, plan: CodeRepairPlan) -> np.ndarray:
        key = (plan.node,) + plan.helpers
        hit = self._newcomer_cache.get(key)
        if hit is not None:
            return hit
        if len(set(plan.helpers)) != self.d or plan.node in plan.helpers:
            raise ValueError(f"need {self.d} distinct helpers != node "
                             f"{plan.node}, got {plan.helpers}")
        a, p = self.alpha, self.p
        # d helper rows + i virtual zero-share rows: (2a, 2a) Vandermonde
        rows_idx = [h - 1 for h in plan.helpers] + \
            list(range(self.n, len(self.gens)))
        psi_sys = self.psi[rows_idx] % p
        psi_inv = gf.gauss_inverse(psi_sys, p).astype(np.int64)
        lam_f = int(self.lams[plan.node - 1])
        lift = np.concatenate([np.eye(a, dtype=np.int64),
                               lam_f * np.eye(a, dtype=np.int64)], axis=1)
        r_full = ((lift @ psi_inv) % p)
        mat = np.ascontiguousarray(r_full[:, :self.d]).astype(np.int64)
        if len(self._newcomer_cache) >= 256:
            self._newcomer_cache.clear()
        self._newcomer_cache[key] = mat
        return mat

    def supports_batched_regen(self) -> bool:
        """The newcomer matrix varies per (node, helpers), so the
        shared-matrix ``regenerate_batch`` does not apply — but every
        plan shares the (alpha, d) geometry, so the store coalesces PM
        repairs through ``regenerate_many_planned``: one launch with one
        matrix per element (DESIGN.md §16.5).
        """
        return True


__all__ = ["ProductMatrixMSR"]
