"""Pluggable code-family subsystem: the abstract ``ErasureCode``
interface every family implements (the port of ``repro.codes.base``,
DESIGN.md §15.1).

A *code class* is the serializable descriptor ``(family, n, k, d, p)``
an object's manifest records; a *code* is the live implementation the
registry (`repro_torch.codes.registry`) builds from it — encode, any-k
reconstruct, bandwidth-optimal regenerate, and the repair-matrix
surface, all running through the same GF dispatch backends and shared
`PlanCache` buckets the double-circulant code uses, on the device the
caller names (None is the card: the Hopper kernels).

Share model (DESIGN.md §15.1): node ``v_j`` (1-indexed) stores
``share_blocks`` = q blocks of S symbols each; a stored share is the
list ``[code_node, blk_0, ..., blk_{q-1}]``.  The double-circulant
family keeps its historical ``[node, a, r]`` layout as the q = 2 case.
The object payload is cut into ``data_blocks`` = D systematic blocks
per stripe; ``data_location(m)`` says which share block carries payload
block m, which is what makes systematic fast reads — and conversion's
systematic share reuse — family-generic.

Every family here sits at the MSR point: q = d - k + 1 blocks per node,
D = k * q payload blocks, helpers send beta = 1 block (S symbols) per
repair, so gamma = d * S = d * B / (k (d - k + 1)) symbols — the
cut-set bound the property suite asserts for every registered family.
"""
from __future__ import annotations

import abc
import dataclasses
import zlib
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import gf
from repro_torch.device import resolve_device
from repro_torch.exec.plan import PlanResult


@dataclasses.dataclass(frozen=True)
class CodeClass:
    """Serializable code-family descriptor: what an object's manifest
    records so every read/repair/convert dispatches through the right
    family (DESIGN.md §15.1).

    >>> cc = CodeClass("double-circulant", n=4, k=2, d=3)
    >>> CodeClass.from_meta(cc.to_meta()) == cc
    True
    """
    family: str
    n: int
    k: int
    d: int
    p: int = gf.DEFAULT_P

    def __post_init__(self):
        if not (1 <= self.k < self.n):
            raise ValueError(f"need 1 <= k < n, got k={self.k}, n={self.n}")
        if not (self.k <= self.d <= self.n - 1):
            raise ValueError(f"need k <= d <= n-1, got d={self.d} "
                             f"(k={self.k}, n={self.n})")

    def key(self) -> str:
        """The family identity string plan tags and decode-cache entries
        are keyed by — distinct for any two inequivalent classes."""
        return f"{self.family}[n{self.n},k{self.k},d{self.d},p{self.p}]"

    def to_meta(self) -> dict:
        return {"family": self.family, "n": self.n, "k": self.k,
                "d": self.d, "p": self.p}

    @classmethod
    def from_meta(cls, meta: dict) -> "CodeClass":
        return cls(family=str(meta["family"]), n=int(meta["n"]),
                   k=int(meta["k"]), d=int(meta["d"]), p=int(meta["p"]))


@dataclasses.dataclass(frozen=True)
class CodeRepairPlan:
    """One node regeneration, reified: which d helpers participate and
    what each sends.

    ``send_matrices[i]`` is the (1, q) GF matrix helper ``helpers[i]``
    applies to its own q stored blocks — the helper-side compute of the
    repair.  One-hot rows mean "send a stored block raw" (the
    double-circulant embedded property); dense rows mean a real
    helper-side projection (product-matrix's Phi_f).  The newcomer
    multiplies the stacked (d, S) sends by the family's
    ``newcomer_matrix`` to rebuild all q lost blocks.
    """
    node: int
    helpers: tuple[int, ...]
    send_matrices: tuple
    blocks_downloaded: int          # d

    @property
    def d(self) -> int:
        return self.blocks_downloaded


def generic_share_crc(blocks: Sequence[np.ndarray]) -> int:
    """CRC32 of one share's logical payload for q-block families: every
    block's ``pack257`` halves chained (any block of a non-systematic
    node can carry the symbol 256, so no raw-uint8 shortcut)."""
    c = 0
    for blk in blocks:
        low, hi = gf.pack257(np.asarray(blk, np.int32))
        c = zlib.crc32(np.ascontiguousarray(low, np.uint8).tobytes(), c)
        c = zlib.crc32(np.ascontiguousarray(hi, np.int64).tobytes(), c)
    return c


def is_one_hot(row: np.ndarray) -> Optional[int]:
    """Index of the single 1 in a (1, q) selector row, or None if the
    row is a real projection — lets the store serve one-hot helper
    sends straight from storage with zero field ops."""
    row = np.asarray(row).reshape(-1)
    nz = np.nonzero(row)[0]
    if len(nz) == 1 and row[nz[0]] == 1:
        return int(nz[0])
    return None


class ErasureCode(abc.ABC):
    """Abstract regenerating code: the encode / reconstruct / regenerate
    / repair-matrix surface the store, scheduler and serving layers
    dispatch through (DESIGN.md §15.1).

    Subclasses are built by the registry from a :class:`CodeClass` on a
    ``device`` (None is the card) and must define the share geometry (``share_blocks``, ``data_blocks``,
    ``derived_rows``), the systematic map (``data_location``,
    ``stripe_share_blocks``), the encode kernel
    (``encode_derived_planned``), the any-k decode surface
    (``decode_rows`` / ``share_rows`` with ``helper_block_ids`` fixing
    the download stacking order), and the regeneration surface
    (``repair_plan`` / ``newcomer_matrix``).
    """

    family: str = "abstract"

    def __init__(self, code_class: CodeClass, *, backend: Optional[str] = None,
                 mesh=None, device=None):
        if code_class.family != self.family:
            raise ValueError(f"{type(self).__name__} builds family "
                             f"{self.family!r}, got {code_class.family!r}")
        if mesh is not None and mesh != 1:
            raise NotImplementedError(
                "stream-axis mesh sharding is not ported yet; pass mesh=None")
        self.code_class = code_class
        self.n, self.k, self.d, self.p = (code_class.n, code_class.k,
                                          code_class.d, code_class.p)
        self.device = resolve_device(device)
        from repro_torch.kernels import dispatch
        be = dispatch.get(backend) if backend else dispatch.select(
            self.p, self.k, self.device)
        self.backend_name = be.name
        self._backend = be
        # shared per (backend, p, device) — the plan cache the
        # double-circulant code hits; family tags keep per-family plan
        # keys and stats separable (§15.4)
        self.planner = be.planner(self.p, self.device)

    # ------------------------------------------------------------- identity
    def family_key(self) -> str:
        """Identity string for plan tags / decode-cache keys."""
        return self.code_class.key()

    # ------------------------------------------------------------- geometry
    @property
    @abc.abstractmethod
    def share_blocks(self) -> int:
        """q: stored blocks per node (alpha = q * S symbols)."""

    @property
    @abc.abstractmethod
    def data_blocks(self) -> int:
        """D: systematic payload blocks per stripe (B = D * S symbols)."""

    @property
    @abc.abstractmethod
    def derived_rows(self) -> int:
        """Rows of the planned encode product — the non-systematic block
        rows ``encode_derived_planned`` computes per stripe."""

    @abc.abstractmethod
    def data_location(self, m: int) -> tuple[int, int]:
        """Payload block m (0-based) lives at (code node 1-indexed,
        share block index) — the systematic map."""

    # --------------------------------------------------------------- encode
    @abc.abstractmethod
    def encode_derived_planned(self, flat: np.ndarray) -> PlanResult:
        """(D, T*S) flattened payload blocks -> planned
        (derived_rows, T*S) non-systematic rows, through the shared
        bucketed plan cache (async; ``.host()`` for exact numpy)."""

    @abc.abstractmethod
    def stripe_share_blocks(self, data: np.ndarray, derived: np.ndarray,
                            node: int) -> list:
        """The q blocks node ``node`` stores for one stripe, assembled
        from the (D, S) payload rows and the (derived_rows, S) encode
        product.  Views are acceptable; the store copies on install."""

    def encode_shares(self, data: np.ndarray) -> np.ndarray:
        """(D, S) payload blocks -> (n, q, S) node shares (the
        convenience/verify path; the store streams through
        ``encode_derived_planned`` + ``stripe_share_blocks``)."""
        data = np.asarray(data, np.int32)
        if data.shape[0] != self.data_blocks:
            raise ValueError(f"expected {self.data_blocks} payload blocks, "
                             f"got {data.shape[0]}")
        derived = self.encode_derived_planned(data).host()
        return np.stack([np.stack([np.asarray(b, np.int32) for b in
                                   self.stripe_share_blocks(data, derived, j)])
                         for j in range(1, self.n + 1)])

    # --------------------------------------------------------------- decode
    def helper_block_ids(self, subset: Sequence[int],
                         ) -> list[tuple[int, int]]:
        """Stacking order of the (k*q, S) decode download matrix:
        (code node, share block) per row.  Node-major by default; the
        double-circulant family overrides to its historical block-major
        [all data rows; all redundancy rows] order so the pre-existing
        cached inverses and plan keys are reused bit-identically."""
        return [(j, b) for j in subset for b in range(self.share_blocks)]

    @abc.abstractmethod
    def decode_rows(self, subset: Sequence[int],
                    rows_needed: Sequence[int]) -> np.ndarray:
        """(len(rows_needed), k*q) GF matrix taking the stacked helper
        downloads (``helper_block_ids`` order) to the requested payload
        block rows — rides on the family's cached subset inverse."""

    @abc.abstractmethod
    def share_rows(self, subset: Sequence[int],
                   lost_nodes: Sequence[int]) -> np.ndarray:
        """(len(lost_nodes)*q, k*q) matrix rebuilding EVERY block of
        each lost node from the stacked downloads (multi-loss repair:
        one matmul per stripe, node-major rows)."""

    def reconstruct(self, subset: Sequence[int],
                    downloads: np.ndarray) -> np.ndarray:
        """Any-k reconstruction: (k*q, S) stacked downloads (in
        ``helper_block_ids`` order) -> (D, S) payload blocks."""
        mat = self.decode_rows(tuple(subset), list(range(self.data_blocks)))
        return self.apply_planned(mat, downloads).host()

    # ----------------------------------------------------------- regenerate
    @abc.abstractmethod
    def repair_plan(self, node: int,
                    available: Optional[Sequence[int]] = None,
                    ) -> Optional[CodeRepairPlan]:
        """A d-helper regeneration plan for ``node`` drawn from
        ``available`` (default: all other nodes), or None when the
        family cannot build one from what is available — the caller
        falls back to the k-subset full decode."""

    @abc.abstractmethod
    def newcomer_matrix(self, plan: CodeRepairPlan) -> np.ndarray:
        """(q, d) matrix taking the stacked (d, S) helper sends to the
        lost node's q blocks (cached per (node, helpers) where the
        family is not helper-invariant)."""

    def helper_send(self, send_matrix, blocks: Sequence[np.ndarray],
                    ) -> np.ndarray:
        """One helper's (S,) contribution: its (1, q) send matrix
        applied to its q stored blocks (see :meth:`helper_sends`)."""
        return self.helper_sends([(send_matrix, blocks)])[0]

    def helper_sends(self, pairs) -> np.ndarray:
        """The (H, S) contributions of H helpers, each a ``(send_matrix,
        blocks)`` pair: its (1, q) send matrix applied to its q stored
        blocks.  One-hot selectors are served raw (zero field ops — the
        embedded property's case); the rest ride ONE per-element batched
        ``matmul_batch`` dispatch on the code's device."""
        out: list = [None] * len(pairs)
        mats, stacks, dense = [], [], []
        for i, (sm, blocks) in enumerate(pairs):
            idx = is_one_hot(sm)
            if idx is not None:
                out[i] = np.asarray(blocks[idx], np.int32)
                continue
            mats.append(np.asarray(sm, np.int32).reshape(1, -1))
            stacks.append(np.stack([np.asarray(b, np.int32) for b in blocks]))
            dense.append(i)
        if dense:
            sent = self.planner.matmul_batch(np.stack(mats), np.stack(stacks),
                                             tag=self.family_key()).host()
            for i, row in zip(dense, sent):
                out[i] = row[0]
        return np.stack(out)

    def regenerate(self, plan: CodeRepairPlan,
                   sends: np.ndarray) -> np.ndarray:
        """(d, S) stacked helper sends -> the lost node's (q, S) blocks."""
        return self.apply_planned(self.newcomer_matrix(plan), sends).host()

    def regenerate_many_planned(self, plans: Sequence[CodeRepairPlan],
                                sends: np.ndarray) -> PlanResult:
        """F independent single-loss regenerations in ONE batched
        dispatch: the per-plan (q, d) newcomer matrices stack to
        (F, q, d), the (F, d, S) helper sends ride ``matmul_batch``'s
        one launch with one matrix per element (DESIGN.md §16.5).  This is the
        coalescing path for families whose newcomer matrix varies per
        (node, helpers) — ``supports_batched_regen()`` families that
        cannot use the store's shared-matrix ``regenerate_batch``.
        ``host()`` yields (F, q, S) rebuilt shares."""
        sends = np.asarray(sends, np.int32)
        if sends.ndim != 3 or sends.shape[0] != len(plans):
            raise ValueError(f"expected ({len(plans)}, d, S) sends, got "
                             f"{sends.shape}")
        mats = np.stack([np.asarray(self.newcomer_matrix(p), np.int32)
                         for p in plans])
        return self.planner.matmul_batch(mats, sends, tag=self.family_key())

    # ------------------------------------------------------------- dispatch
    def apply_planned(self, mat, blocks) -> PlanResult:
        """Family-tagged planned (mat @ blocks) mod p through the shared
        bucketed plan cache, on the code's device.  With planning disabled
        the planner still launches on that device; it only skips the plan
        accounting."""
        return self.planner.matmul(mat, blocks, tag=self.family_key())

    # ------------------------------------------------------------ integrity
    def share_crc_blocks(self, blocks: Sequence[np.ndarray]) -> int:
        """Put-time CRC of one share's q blocks (the store's integrity
        ledger entry).  Generic pack257 chaining; the double-circulant
        family overrides to its historical (data-uint8, pack257(red))
        formula so existing ledgers stay byte-identical."""
        return generic_share_crc(blocks)

    # ----------------------------------------------------------- accounting
    def alpha_symbols(self, block_symbols: int) -> int:
        """Per-node storage: q * S symbols."""
        return self.share_blocks * block_symbols

    def gamma_regenerate_symbols(self, block_symbols: int) -> int:
        """Repair bandwidth: d * S = d * B / (k (d - k + 1)) — the MSR
        cut-set point every family here sits at."""
        return self.d * block_symbols

    def gamma_reconstruct_symbols(self, block_symbols: int) -> int:
        """Classical-EC-style repair (full k-subset decode): k*q*S = B."""
        return self.k * self.share_blocks * block_symbols

    def storage_overhead(self) -> float:
        """Stored symbols per payload symbol: n*q / D (= n/k at MSR)."""
        return self.n * self.share_blocks / self.data_blocks

    def supports_batched_regen(self) -> bool:
        """True when the store may coalesce this family's single-loss
        repairs into batched dispatches (one launch per window)."""
        return False


__all__ = ["CodeClass", "CodeRepairPlan", "ErasureCode",
           "generic_share_crc", "is_one_hot"]
