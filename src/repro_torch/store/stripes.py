"""Stripe codec: arbitrary-size objects <-> fixed MSR stripes of any
registered code family (the port of ``repro.store.stripes``,
DESIGN.md §10.1, §15.3).

An object (bytes, or any numpy array) is serialized to a byte payload,
converted to GF(p) symbols, zero-padded to a whole number of stripes and
cut into (T, D, S) payload blocks: T stripes of the family's
D = ``data_blocks`` blocks (n = 2k for the double-circulant code), S =
``stripe_symbols`` symbols each.  The original byte length is recorded
in the :class:`StripeMap` so padding strips off bit-exactly on
reassembly.

Every family's encode is independent per symbol column, so a window of
stripes folds into ONE (D, T*S) encode launch instead of T small ones.

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
    # 3-D view of the destination so the strided transpose writes land
    # directly in the pooled buffer (one pass, no intermediate copy)
    with gf.staged("pack"):
        np.copyto(out.reshape(tuple(blocks.shape[a] for a in axes)),
                  np.transpose(blocks, axes))
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


class StripeCodec:
    """Chunk + encode + place for one code class: the store's codec for
    any registered :class:`~repro_torch.codes.base.ErasureCode`.

    One stripe carries ``D = code.data_blocks`` payload blocks of S
    symbols, each node stores ``q = code.share_blocks`` blocks, and a
    window's non-systematic rows come from ONE folded
    ``encode_derived_planned`` launch over the (D, T*S) stream view.

    Parameters
    ----------
    code : ErasureCode
        The family's live code (its planner, inverse caches and device).
    layout : placement.RackLayout
        Physical node ring (may be larger than n) with rack assignment;
        raises ValueError when some rotation puts more than n - k of a
        stripe's shares in one rack.
    stripe_symbols : int
        Block size S; small objects still occupy one full stripe
        (padded), so pick S against the expected object size.
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
                f"{worst} shares in one rack > n-k = {self.n - self.k}; "
                f"add racks or nodes")

    # ------------------------------------------------------------- placement
    def placement(self, stripe: int) -> tuple[int, ...]:
        """Physical node (1-indexed) of each code node's share."""
        return placement.rotate_placement(self.layout, self.n, stripe)

    # ----------------------------------------------------------------- chunk
    def chunk(self, payload: bytes) -> tuple[np.ndarray, StripeMap]:
        """payload -> ((T, D, S) int32 payload blocks, StripeMap).

        The byte payload is written straight into the freshly allocated
        block array — cast and stripe padding fused into one strided
        write (DESIGN.md §16.1)."""
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
        """(T, D, S) payload blocks -> the (D, T*S) stream view the encode
        dispatches over (the stripe axis folded into the symbol axis;
        every family's encode is column-independent).

        ``out`` (int32, exactly (D, T*S)) receives the transpose in place
        — the zero-copy staging path (DESIGN.md §16): the put passes a
        pooled staging buffer so flatten and staging are one strided
        write."""
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


__all__ = ["StripeMap", "StripeCodec"]
