"""Fused batched repair engine (the port of ``repro.core.repair``).

Everything a repairing or reconstructing reader does reduces to one GF
matmul per request through the dispatched backend, with the tiny host-side
linear algebra precomputed (the repair matrix) or cached (reconstruction
inverses).

Regeneration (paper §III-C).  The newcomer's computation is linear in the
d = k+1 downloaded helper blocks, so it folds into a single (2, k+1)
repair matrix R applied to H = [r_{i-1}; a_{i+1}; ...; a_{i+k}]:

    [a_lost; r_new] = R @ H  mod p,          R =
      row 0 (decode):    [c_k^{-1},  -c_k^{-1} c_{k-1}, ..., -c_k^{-1} c_1, 0]
      row 1 (re-encode): [0,          c_k,  c_{k-1},     ...,          c_1]

R is the same for every node (circulant invariance), so F failed nodes
regenerate in ONE batched kernel launch against the shared matrix.  The
fused engine hands that launch r_{i-1} and the k helper blocks as two row
sources where they lie (``make_regen_fn``): no concatenation, no
epilogue.

Reconstruction (paper §III-B).  The 2k x 2k system matrix depends only on
which k nodes are read, so inverses are cached in an LRU keyed by the
code family and the sorted node subset.  Multi-failure repair stacks the
re-encode rows of the failed nodes under the inverse, so the full data and
every lost redundancy block come out of one decode matmul, whose
contraction operand is the data and redundancy downloads as two row
sources (no concatenated copy) on a fused engine.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import as_int32, device_of, resolve_device
from repro_torch.exec.plan import PlanResult, make_regen_fn, planning_enabled

from . import gf
from .circulant import CodeSpec

MatmulFn = Callable[..., torch.Tensor]  # (A, B, p) -> (A @ B) mod p


def build_repair_matrix(spec: CodeSpec) -> np.ndarray:
    """The (2, k+1) fused repair matrix R (one per code, see module doc).

    Column 0 multiplies r_{i-1}; column 1+j multiplies the j-th helper data
    block a_{(i+j) mod n} (plan order, j = 0..k-1).  Row 0 recovers the
    lost data block a_{i-1}, row 1 re-encodes the lost redundancy r_i.
    """
    k, p = spec.k, spec.p
    c = np.asarray(spec.c, dtype=np.int64) % p
    ck_inv = pow(int(c[-1]), p - 2, p)
    r = np.zeros((2, k + 1), dtype=np.int64)
    # r_{i-1} = c_k a_{i-1} + sum_{u=1..k-1} c_u a_{(i-1+k-u) mod n}; the
    # u-th term is helper column 1 + (k-u-1), so
    #   a_{i-1} = c_k^{-1} r_{i-1} - sum_u c_k^{-1} c_u a_{(i-1+k-u)}.
    r[0, 0] = ck_inv
    for j in range(k - 1):                      # j = k-u-1  <->  u = k-1-j
        r[0, 1 + j] = (-ck_inv * c[k - 2 - j]) % p
    # r_i = sum_{u=1..k} c_u a_{(i-1+k+1-u) mod n}: helper column 1 + (k-u).
    for j in range(k):                          # j = k-u    <->  u = k-j
        r[1, 1 + j] = c[k - 1 - j]
    return (r % p).astype(np.int32)


class DecodeCacheInfo(NamedTuple):
    hits: int
    misses: int
    size: int
    maxsize: int


# Every live DecodeInverseCache, for the per-family stats surface.
_CACHE_LOCK = threading.Lock()
_LIVE_CACHES: "weakref.WeakSet[DecodeInverseCache]" = weakref.WeakSet()


def decode_cache_stats() -> dict[str, DecodeCacheInfo]:
    """Aggregate decode-inverse cache counters per code-family identity
    across every live cache."""
    agg: dict[str, list[int]] = {}
    with _CACHE_LOCK:
        caches = list(_LIVE_CACHES)
    for c in caches:
        row = agg.setdefault(c.family, [0, 0, 0, 0])
        info = c.cache_info()
        row[0] += info.hits
        row[1] += info.misses
        row[2] += info.size
        row[3] += info.maxsize
    return {fam: DecodeCacheInfo(*row) for fam, row in sorted(agg.items())}


class DecodeInverseCache:
    """LRU of reconstruction inverses keyed by (code family, sorted k-node
    subset).  The O(n^3) host-side ``gf.gauss_inverse`` runs once per
    subset, not once per call.

    Parameters
    ----------
    spec : CodeSpec, optional
        The double-circulant code whose system matrices are inverted.
    maxsize : int
        LRU capacity.
    family : str, optional
        Family identity baked into every entry key; defaults to the
        double-circulant identity derived from ``spec``.
    matrix_fn : callable, optional
        ``subset -> square ndarray`` for generator-matrix families;
        mutually exclusive with ``spec``.
    k, p : int, optional
        Subset size / field modulus when ``matrix_fn`` is used.
    """

    def __init__(self, spec: Optional[CodeSpec] = None, maxsize: int = 128,
                 *, family: Optional[str] = None,
                 matrix_fn: Optional[Callable] = None,
                 k: Optional[int] = None, p: Optional[int] = None):
        self.spec = spec
        if spec is not None:
            if matrix_fn is not None:
                raise ValueError("pass spec or matrix_fn, not both")
            self.k, self.n, self.p = spec.k, spec.n, spec.p
            self._m = spec.matrix_m()           # (n, n)
            self._matrix_fn = None
            family = family or (f"double-circulant[n{spec.n},k{spec.k},"
                                f"p{spec.p}]")
        else:
            if matrix_fn is None or k is None or p is None:
                raise ValueError("matrix_fn caches need matrix_fn, k and p")
            self.k, self.p = int(k), int(p)
            self.n = None
            self._matrix_fn = matrix_fn
            family = family or "generator-matrix"
        self.family = str(family)
        self.maxsize = max(1, maxsize)
        self._entries: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0
        with _CACHE_LOCK:
            _LIVE_CACHES.add(self)

    def system_matrix(self, subset: tuple[int, ...]) -> np.ndarray:
        """The square decode system for the (sorted) subset."""
        if self._matrix_fn is not None:
            return np.asarray(self._matrix_fn(subset), np.int64) % self.p
        cols = [i - 1 for i in subset]
        return np.concatenate(
            [np.eye(self.n, dtype=np.int64)[:, cols], self._m[:, cols]],
            axis=1,
        ).T % self.p

    def inverse(self, subset: Sequence[int]) -> np.ndarray:
        """Cached inverse of the subset's system matrix."""
        key = tuple(subset)
        if sorted(set(key)) != list(key) or len(key) != self.k:
            raise ValueError(f"need a sorted set of k={self.k} distinct "
                             f"nodes, got {key}")
        entry_key = (self.family,) + key       # family identity in the key
        hit = self._entries.get(entry_key)
        if hit is not None:
            self.hits += 1
            self._entries.move_to_end(entry_key)
            return hit
        self.misses += 1
        inv = gf.gauss_inverse(self.system_matrix(key), self.p)
        self._entries[entry_key] = inv
        if len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return inv

    def cache_info(self) -> DecodeCacheInfo:
        return DecodeCacheInfo(self.hits, self.misses, len(self._entries),
                               self.maxsize)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0


class RepairEngine:
    """Fused decode-side compute for one code: every repair/reconstruct
    request is a single dispatched GF matmul.

    Parameters
    ----------
    spec : CodeSpec
        The code being repaired.
    matmul : callable
        Backend ``(a, b, p) -> (a @ b) mod p`` primitive on tensors.
    fused : bool
        False for custom injected matmuls: every field op goes through the
        injected function with one concatenated ``b`` — regeneration is
        the literal stacked (2, k+1) @ (k+1, S) product and a decode gets
        the concatenated download.  True hands the backend's matmul row
        sources where they lie (its ``b`` may be a tuple).
    inverse_cache_size : int
        Capacity of :attr:`decode_cache`.
    planner : repro_torch.exec.plan.PlanCache, optional
        When set, the ``*_planned`` methods run through it.
    device : torch.device or str, optional
        Where numpy operands go; None is the card.  Tensor operands keep
        their own device.
    """

    def __init__(self, spec: CodeSpec, matmul: MatmulFn, *,
                 fused: bool = True, inverse_cache_size: int = 128,
                 planner=None, device=None):
        self.spec = spec
        self.k, self.n, self.p = spec.k, spec.n, spec.p
        self._mm = matmul
        self._fused = fused
        self.device = resolve_device(device)
        self._mt = np.ascontiguousarray(spec.matrix_m().T)   # (n, n)
        self._rmat_np = build_repair_matrix(spec)
        self._rmat = torch.from_numpy(self._rmat_np).to(self.device)
        self.decode_cache = DecodeInverseCache(spec,
                                               maxsize=inverse_cache_size)
        self.planner = planner

    def _planned(self) -> bool:
        return self.planner is not None and planning_enabled()

    def _dev(self, *xs) -> torch.device:
        return device_of(*xs, device=self.device)

    def _rmat_on(self, dev: torch.device) -> torch.Tensor:
        return self._rmat if self._rmat.device == dev else self._rmat.to(dev)

    # ------------------------------------------------------------ regenerate
    def repair_matrix(self, i: int | None = None) -> np.ndarray:
        """R for node v_i — identical for every i (circulant invariance)."""
        if i is not None and not 1 <= i <= self.n:
            raise ValueError(f"node {i} out of range 1..{self.n}")
        return self._rmat_np

    def apply(self, mat, blocks) -> torch.Tensor:
        """(mat @ blocks) mod p through the dispatched backend, on the
        device of ``blocks``.  ``blocks`` may be a tuple of row sources,
        read as if concatenated along the contraction axis (a custom
        matmul gets them concatenated)."""
        if isinstance(blocks, tuple):
            dev = self._dev(*blocks, mat)
            srcs = tuple(as_int32(b, self.p, dev) for b in blocks)
            return self._mm(as_int32(mat, self.p, dev), srcs if self._fused
                            else torch.cat(srcs, dim=-2), self.p)
        dev = self._dev(blocks, mat)
        return self._mm(as_int32(mat, self.p, dev),
                        as_int32(blocks, self.p, dev), self.p)

    def apply_planned(self, mat, blocks) -> PlanResult:
        """Planned (mat @ blocks) mod p; ``.host()`` on the result blocks
        and returns exact numpy.  ``blocks`` may be a tuple of row
        sources.  Falls back to :meth:`apply` without a planner."""
        if self._planned():
            return self.planner.matmul(mat, blocks)
        out = self.apply(mat, blocks)
        return PlanResult(out, out.shape[-1])

    def regenerate_stacked(self, i: int, r_prev, next_data) -> torch.Tensor:
        """Fused newcomer compute: one (2, k+1) repair-matrix application —
        one matmul launch over the row sources (r_prev, next_data) (custom
        matmuls get the literal stacked product).

        Returns the (2, S) stack [a_{i-1}; r_i] — bit-exactly the lost
        node's pair.
        """
        dev = self._dev(r_prev, next_data)
        r_prev = as_int32(r_prev, self.p, dev)
        next_data = as_int32(next_data, self.p, dev)
        if next_data.shape[0] != self.k:
            raise ValueError(f"expected {self.k} helper data blocks, "
                             f"got {next_data.shape[0]}")
        rmat = self._rmat_on(dev)
        if self._fused:
            return make_regen_fn(self._mm, self.p)(rmat, r_prev, next_data)
        helpers = torch.cat([r_prev[None, :], next_data], dim=0)
        return self._mm(rmat, helpers, self.p)

    def regenerate(self, i: int, r_prev, next_data,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        out = self.regenerate_stacked(i, r_prev, next_data)
        return out[0], out[1]

    def regenerate_planned(self, i: int, r_prev, next_data) -> PlanResult:
        """Planned fused newcomer compute, asynchronous."""
        if np.shape(next_data)[0] != self.k:
            raise ValueError(f"expected {self.k} helper data blocks, "
                             f"got {np.shape(next_data)[0]}")
        if self._planned():
            return self.planner.regenerate(self._rmat_np, r_prev, next_data)
        out = self.regenerate_stacked(i, r_prev, next_data)
        return PlanResult(out, out.shape[-1])

    def _check_batch(self, nodes, r_prevs, next_data) -> None:
        f = len(nodes)
        if tuple(r_prevs.shape[:1]) != (f,) or \
                tuple(next_data.shape[:2]) != (f, self.k):
            raise ValueError(f"helper shapes {tuple(r_prevs.shape)}/"
                             f"{tuple(next_data.shape)} do not match {f} "
                             f"nodes, k={self.k}")

    def regenerate_batch_planned(self, nodes: Sequence[int], r_prevs,
                                 next_data) -> PlanResult:
        """Planned batched fused regeneration; ``.host()`` returns the exact
        (F, 2, S) stack.  Falls back to :meth:`regenerate_batch`."""
        self._check_batch(nodes, r_prevs, next_data)
        if self._planned():
            return self.planner.regenerate_batch(self._rmat_np, r_prevs,
                                                 next_data)
        out = self.regenerate_batch(nodes, r_prevs, next_data)
        return PlanResult(out, out.shape[-1], batch=len(nodes))

    def regenerate_batch(self, nodes: Sequence[int], r_prevs, next_data, *,
                         tile_symbols: int | None = None) -> torch.Tensor:
        """Batched fused regeneration over failed nodes.

        r_prevs: (F, S) — r_{i-1} per failed node, plan order.
        next_data: (F, k, S) — the k helper data blocks per failed node.
        Returns (F, 2, S): [a_lost; r_new] per node.

        Each ``tile_symbols`` tile of the stream axis (default: the whole
        stream) is ONE matmul launch over all F nodes against the shared
        repair matrix; custom matmuls run node by node.
        """
        dev = self._dev(r_prevs, next_data)
        r_prevs = as_int32(r_prevs, self.p, dev)
        next_data = as_int32(next_data, self.p, dev)
        self._check_batch(nodes, r_prevs, next_data)
        s = r_prevs.shape[-1]
        tile = s if tile_symbols is None else max(1, tile_symbols)
        parts = []
        for s0 in range(0, s, tile):
            rp = r_prevs[:, s0:s0 + tile]
            nd = next_data[:, :, s0:s0 + tile]
            if tile != s:
                rp, nd = rp.contiguous(), nd.contiguous()
            parts.append(self._regen_tile_batch(nodes, rp, nd))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def _regen_tile_batch(self, nodes, r_prevs, next_data) -> torch.Tensor:
        if self._fused:
            return make_regen_fn(self._mm, self.p)(
                self._rmat_on(r_prevs.device), r_prevs, next_data)
        return torch.stack([self.regenerate_stacked(i, r_prevs[f],
                                                    next_data[f])
                            for f, i in enumerate(nodes)])

    # ----------------------------------------------------------- reconstruct
    def decode_matrix(self, subset: Sequence[int]) -> np.ndarray:
        """Cached (n, n) any-k decode matrix for a sorted node subset."""
        return self.decode_cache.inverse(tuple(subset))

    def decode_repair_matrix(self, subset: Sequence[int],
                             failed: Sequence[int]) -> np.ndarray:
        """(n + F, n) combined decode + re-encode matrix: rows 0..n-1
        recover the data, row n + j re-encodes the redundancy block of
        ``failed[j]``."""
        inv = self.decode_cache.inverse(tuple(subset))
        rows = np.asarray([self._mt[f - 1] for f in failed], dtype=np.int64)
        red_rows = (rows @ inv.astype(np.int64)) % self.p
        return np.concatenate([inv.astype(np.int64), red_rows],
                              axis=0).astype(np.int32)

    def split_decode_output(self, out):
        """Split a ``decode_repair_matrix`` product into
        (data (n, S), failed_red (F, S))."""
        return out[: self.n], out[self.n:]

    def reconstruct(self, node_ids: Sequence[int], data_blocks,
                    red_blocks) -> torch.Tensor:
        """Any-k reconstruction via the cached inverse (paper §III-B).
        ``node_ids`` may arrive in any order; rows are permuted to the
        sorted subset so every ordering shares one cache entry."""
        ids = [int(x) for x in node_ids]
        if len(set(ids)) != self.k:
            raise ValueError(f"need k={self.k} distinct nodes, got {ids}")
        order = sorted(range(self.k), key=lambda j: ids[j])
        subset = tuple(ids[j] for j in order)
        dev = self._dev(data_blocks, red_blocks)
        data_blocks = as_int32(data_blocks, self.p, dev)
        red_blocks = as_int32(red_blocks, self.p, dev)
        if order != list(range(self.k)):
            sel = torch.as_tensor(order, device=dev)
            data_blocks, red_blocks = data_blocks[sel], red_blocks[sel]
        return self._decode(self.decode_matrix(subset), data_blocks,
                            red_blocks)

    def reconstruct_with_repair(self, node_ids: Sequence[int], data_blocks,
                                red_blocks, failed: Sequence[int],
                                ) -> tuple[torch.Tensor, torch.Tensor]:
        """One-matmul multi-failure repair: (data (n, S), failed_red (F, S))
        with failed_red rows in ``failed`` order.  ``node_ids`` must be
        sorted."""
        subset = tuple(int(x) for x in node_ids)
        dev = self._dev(data_blocks, red_blocks)
        mat = self.decode_repair_matrix(subset, failed)
        return self.split_decode_output(self._decode(
            mat, as_int32(data_blocks, self.p, dev),
            as_int32(red_blocks, self.p, dev)))

    def _decode(self, mat, data_blocks: torch.Tensor,
                red_blocks: torch.Tensor) -> torch.Tensor:
        """(mat @ [data_blocks; red_blocks]) mod p.  A fused engine hands
        the two downloads to the matmul as row sources where they lie; a
        custom matmul gets them concatenated, as the reference builds
        them."""
        blocks = (data_blocks, red_blocks) if self._fused else \
            torch.cat([data_blocks, red_blocks], dim=0)
        return self._mm(as_int32(mat, self.p, data_blocks.device), blocks,
                        self.p)


__all__ = ["RepairEngine", "DecodeInverseCache", "DecodeCacheInfo",
           "build_repair_matrix", "decode_cache_stats"]
