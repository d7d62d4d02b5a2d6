"""Stripe manager: arbitrary-size objects <-> fixed MSR stripes (the port
of ``repro.store.stripes``, DESIGN.md §10.1).

An object (bytes, or any numpy array) is serialized to a byte payload,
converted to GF(p) symbols, zero-padded to a whole number of stripes and
cut into (T, n, S) data blocks: T stripes of the code's n = 2k blocks,
S = ``stripe_symbols`` symbols each.  The original byte length is
recorded in the :class:`StripeMap` so padding strips off bit-exactly on
reassembly.

Encoding exploits that the circulant encode is independent per symbol
column: ALL T stripes of an object are folded into ONE (n, T*S) encode
launch instead of T small ones.

Physical placement rides on `core.placement`: share j of stripe t lands
on node ``rotate_placement(layout, n, t)[j]``, rotating stripes around
the node ring so load spreads and a node failure costs each stripe at
most one share, while the round-robin rack layout keeps any stripe's
rack-correlated loss within the code's n - k erasure budget
(`max_shares_per_rack`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import gf, placement
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR


def _flatten_into(blocks: np.ndarray, axes: tuple, out_shape: tuple,
                  out: np.ndarray | None) -> np.ndarray:
    """Transpose ``blocks`` by ``axes`` into ``out_shape``, writing into
    ``out`` in place when given (the zero-copy staging path, DESIGN.md
    §16) or materializing a fresh contiguous array otherwise."""
    if out is None:
        return np.ascontiguousarray(
            np.transpose(blocks, axes)).reshape(out_shape)
    if out.shape != out_shape or out.dtype != np.int32:
        raise ValueError(f"staging out must be int32 {out_shape}, got "
                         f"{out.dtype} {out.shape}")
    from time import perf_counter
    t0 = perf_counter()
    # 3-D view of the destination so the strided transpose writes land
    # directly in the pooled buffer (one pass, no intermediate copy)
    np.copyto(out.reshape(tuple(blocks.shape[a] for a in axes)),
              np.transpose(blocks, axes))
    gf.record_stage("pack", perf_counter() - t0)
    return out


@dataclasses.dataclass(frozen=True)
class StripeMap:
    """Geometry of one striped object (everything needed to reassemble).

    Parameters
    ----------
    orig_bytes : int
        Payload length before symbol conversion and padding.
    n_stripes : int
        Number of stripes the object spans (>= 1 even for empty objects,
        so every object owns storable shares and a repairable footprint).
    stripe_symbols : int
        Symbols per data block (the code's S) — each stripe carries
        ``n * stripe_symbols`` payload symbols.
    """
    orig_bytes: int
    n_stripes: int
    stripe_symbols: int

    def payload_symbols(self, n: int) -> int:
        """Padded symbol capacity across all stripes."""
        return self.n_stripes * n * self.stripe_symbols


class StripeManager:
    """Chunk + encode + place: the store's codec for one code spec.

    Parameters
    ----------
    spec : CodeSpec
        The [n = 2k, k] double circulant code every stripe uses.
    layout : placement.RackLayout
        Physical node ring (may be larger than n) with rack assignment.
    stripe_symbols : int
        Data-block size S; small objects still occupy one full stripe
        (padded), so pick S against the expected object size.
    code : DoubleCirculantMSR, optional
        Share an existing code instance (and its decode-inverse cache).
    backend : str, optional
        Pin a dispatch backend by name (forwarded to the code).
    mesh : None or 1
        Forwarded to the code; stream-axis sharding is not ported yet.
    device : torch.device or str, optional
        Where a new code computes (None is the card); ignored when
        ``code`` is given (the code owns its device).
    """

    def __init__(self, spec: CodeSpec, layout: placement.RackLayout, *,
                 stripe_symbols: int = 1 << 12,
                 code: DoubleCirculantMSR | None = None,
                 backend: str | None = None, mesh=None, device=None):
        self.spec = spec
        self.k, self.n, self.p = spec.k, spec.n, spec.p
        self.layout = layout
        self.stripe_symbols = int(stripe_symbols)
        if self.stripe_symbols < 1:
            raise ValueError("stripe_symbols must be >= 1")
        self.code = code or DoubleCirculantMSR(spec, backend=backend,
                                               mesh=mesh, device=device)
        worst = max(placement.max_shares_per_rack(
            layout, self.placement(t)) for t in range(layout.n_nodes))
        if worst > self.n - self.k:
            raise ValueError(
                f"layout unsafe: some stripe puts {worst} shares in one "
                f"rack > n-k = {self.n - self.k}; add racks or nodes")

    # ------------------------------------------------------------- placement
    def placement(self, stripe: int) -> tuple[int, ...]:
        """Physical node (1-indexed) of each code node's share for stripe
        ``stripe`` — entry j holds code node v_{j+1}'s pair."""
        return placement.rotate_placement(self.layout, self.n, stripe)

    # ----------------------------------------------------------------- chunk
    def chunk(self, payload: bytes) -> tuple[np.ndarray, StripeMap]:
        """payload -> ((T, n, S) int32 data blocks, StripeMap).

        The byte payload is written straight into the freshly allocated
        block array — cast and stripe padding fused into one strided
        write (DESIGN.md §16.1)."""
        per_stripe = self.n * self.stripe_symbols
        t = max(1, -(-len(payload) // per_stripe))
        blocks = np.empty((t, self.n, self.stripe_symbols), np.int32)
        gf.bytes_to_symbols_into(payload, blocks.reshape(-1), self.p)
        return blocks, StripeMap(orig_bytes=len(payload), n_stripes=t,
                                 stripe_symbols=self.stripe_symbols)

    def assemble(self, blocks: np.ndarray, smap: StripeMap) -> bytes:
        """Inverse of :meth:`chunk`: (T, n, S) data blocks -> payload."""
        sym = np.asarray(blocks, np.int32).reshape(-1)
        return gf.symbols_to_bytes(sym)[: smap.orig_bytes]

    # ---------------------------------------------------------------- encode
    def flatten(self, blocks: np.ndarray,
                out: np.ndarray | None = None) -> np.ndarray:
        """(T, n, S) data blocks -> the (n, T*S) stream view the encode
        dispatches over (the stripe axis folds into the symbol axis —
        the circulant encode is independent per symbol column).

        ``out`` (int32, exactly (n, T*S)) receives the transpose in
        place — the zero-copy staging path (DESIGN.md §16): the put
        pipeline passes a view into a pooled, bucket-padded buffer so
        flatten + pad collapse into one strided write."""
        t, n, s = blocks.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} blocks per stripe, got {n}")
        return _flatten_into(blocks, (1, 0, 2), (n, t * s), out)

    def unflatten(self, flat: np.ndarray, t: int) -> np.ndarray:
        """Inverse of :meth:`flatten`: (n, T*S) -> (T, n, S)."""
        return np.ascontiguousarray(np.transpose(
            np.asarray(flat, np.int32).reshape(self.n, t, -1), (1, 0, 2)))

    def encode(self, blocks: np.ndarray) -> np.ndarray:
        """(T, n, S) data blocks -> (T, n, S) redundancy blocks.

        One circulant encode launch for the whole object: the stripe
        axis is folded into the symbol axis ((n, T*S) view), encoded
        once on the code's device, and unfolded.  (The store's put path
        tiles the same flatten/encode/unflatten over stripe windows so
        share placement overlaps the next window's encode.)
        """
        flat = self.flatten(blocks)
        red = self.code.encode(flat).cpu().numpy()
        return self.unflatten(red, blocks.shape[0])


class StripeCodec:
    """Family-generic stripe codec: chunk + encode + place for any
    registered :class:`~repro_torch.codes.base.ErasureCode` (DESIGN.md
    §15.3).

    The generic counterpart of :class:`StripeManager` — one stripe
    carries ``D = code.data_blocks`` payload blocks of S symbols, each
    node stores ``q = code.share_blocks`` blocks, and the whole object's
    non-systematic rows are produced by ONE folded
    ``encode_derived_planned`` dispatch over the (D, T*S) stream view.
    """

    def __init__(self, code, layout: placement.RackLayout, *,
                 stripe_symbols: int):
        self.code = code
        self.layout = layout
        self.n, self.k, self.d, self.p = code.n, code.k, code.d, code.p
        self.stripe_symbols = int(stripe_symbols)
        if self.stripe_symbols < 1:
            raise ValueError("stripe_symbols must be >= 1")
        worst = max(placement.max_shares_per_rack(
            layout, self.placement(t)) for t in range(layout.n_nodes))
        if worst > self.n - self.k:
            raise ValueError(
                f"layout unsafe for {code.family_key()}: some stripe puts "
                f"{worst} shares in one rack > n-k = {self.n - self.k}")

    # ------------------------------------------------------------- placement
    def placement(self, stripe: int) -> tuple[int, ...]:
        """Physical node (1-indexed) of each code node's share."""
        return placement.rotate_placement(self.layout, self.n, stripe)

    # ----------------------------------------------------------------- chunk
    def chunk(self, payload: bytes) -> tuple[np.ndarray, StripeMap]:
        """payload -> ((T, D, S) int32 payload blocks, StripeMap), in one
        fused write like :meth:`StripeManager.chunk`."""
        d_blocks = self.code.data_blocks
        per_stripe = d_blocks * self.stripe_symbols
        t = max(1, -(-len(payload) // per_stripe))
        blocks = np.empty((t, d_blocks, self.stripe_symbols), np.int32)
        gf.bytes_to_symbols_into(payload, blocks.reshape(-1), self.p)
        return blocks, StripeMap(orig_bytes=len(payload), n_stripes=t,
                                 stripe_symbols=self.stripe_symbols)

    def assemble(self, blocks: np.ndarray, smap: StripeMap) -> bytes:
        """Inverse of :meth:`chunk`: (T, D, S) payload blocks -> bytes."""
        sym = np.asarray(blocks, np.int32).reshape(-1)
        return gf.symbols_to_bytes(sym)[: smap.orig_bytes]

    # ---------------------------------------------------------------- encode
    def flatten(self, blocks: np.ndarray,
                out: np.ndarray | None = None) -> np.ndarray:
        """(T, D, S) -> (D, T*S) stream view (stripe axis folded into
        the symbol axis; every family's encode is column-independent).
        ``out`` stages in place like ``StripeManager.flatten``."""
        t, d_blocks, s = blocks.shape
        if d_blocks != self.code.data_blocks:
            raise ValueError(f"expected {self.code.data_blocks} payload "
                             f"blocks per stripe, got {d_blocks}")
        return _flatten_into(blocks, (1, 0, 2), (d_blocks, t * s), out)

    def unflatten_rows(self, flat: np.ndarray, rows: int,
                       t: int) -> np.ndarray:
        """(rows, T*S) encode/decode product -> (T, rows, S)."""
        return np.ascontiguousarray(np.transpose(
            np.asarray(flat, np.int32).reshape(rows, t, -1), (1, 0, 2)))

    def encode_window(self, blocks: np.ndarray) -> np.ndarray:
        """(T, D, S) payload blocks -> (T, derived_rows, S) derived rows
        in ONE planned launch for the whole window."""
        flat = self.flatten(blocks)
        derived = self.code.encode_derived_planned(flat).host()
        return self.unflatten_rows(derived, self.code.derived_rows,
                                   blocks.shape[0])

    def stripe_shares(self, data: np.ndarray, derived: np.ndarray):
        """One stripe's (D, S) payload + (derived_rows, S) product ->
        per-node block lists, 1-indexed by code node."""
        return {j: self.code.stripe_share_blocks(data, derived, j)
                for j in range(1, self.n + 1)}


__all__ = ["StripeMap", "StripeManager", "StripeCodec"]
