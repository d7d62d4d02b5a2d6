"""Tree <-> MSR block placement and rack-aware physical placement (the port
of ``repro.core.placement``).

The byte mapping is deliberately dumb and auditable:
  tree -> flat list of (dtype, shape, raw bytes) -> one byte stream
       -> GF(p) symbols -> pad to a multiple of n -> reshape (n, S).

A tree is nested dicts, lists, tuples (named or not) and None, with
tensors, numpy arrays or scalars as leaves.  It flattens exactly as the
reference's ``jax.tree_util`` does, so both packages write the same bytes
for the same tree: a plain dict's keys in sorted order (an ``OrderedDict``
keeps its own order), sequences in order, None holding no leaf.  Each
leaf's meta is the reference's ``{dtype, shape, nbytes}`` with the numpy
dtype name; a bfloat16 tensor, which numpy cannot hold, writes its raw
16-bit patterns under the dtype name ``"bfloat16"``, as the reference's
``np.asarray`` of a JAX bfloat16 array does.

Systematic property: restoring WITHOUT failures reads only the raw data
blocks — ``blocks_to_pytree(data_blocks)`` never touches field arithmetic.

Physical placement: ``RackLayout`` assigns the storage nodes to failure
domains (racks) so a whole-rack loss can be checked against the code's
n - k erasure budget (``RackLayout.survives_rack_loss``).
"""
from __future__ import annotations

import json
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.place import Sharded

from . import gf


@dataclass
class TreeSpec:
    """Static metadata needed to rebuild the tree from bytes."""
    treedef_repr: str
    leaves: list[dict]       # [{dtype, shape, nbytes}]
    total_bytes: int
    n_blocks: int
    block_symbols: int

    def to_json(self) -> str:
        return json.dumps({
            "treedef_repr": self.treedef_repr,
            "leaves": self.leaves,
            "total_bytes": self.total_bytes,
            "n_blocks": self.n_blocks,
            "block_symbols": self.block_symbols,
        })

    @staticmethod
    def from_json(s: str) -> "TreeSpec":
        d = json.loads(s)
        return TreeSpec(**d)


@dataclass(frozen=True)
class RackLayout:
    """Node -> failure-domain (rack) assignment for correlated failures.

    Parameters
    ----------
    n_nodes : int
        Number of storage nodes.
    racks : tuple of int
        ``racks[i]`` is the rack id of node ``v_{i+1}`` (0-based rack ids).

    Notes
    -----
    Build one with :func:`rack_layout`, which round-robins nodes across
    racks so rack sizes differ by at most one.
    """
    n_nodes: int
    racks: tuple[int, ...]

    def __post_init__(self):
        if len(self.racks) != self.n_nodes:
            raise ValueError(f"need one rack id per node: "
                             f"{len(self.racks)} != {self.n_nodes}")

    @property
    def n_racks(self) -> int:
        return len(set(self.racks))

    def rack_of(self, node: int) -> int:
        """Rack id of node ``v_node`` (1-indexed)."""
        if not 1 <= node <= self.n_nodes:
            raise ValueError(f"node {node} out of range 1..{self.n_nodes}")
        return self.racks[node - 1]

    def nodes_in(self, rack: int) -> tuple[int, ...]:
        """All (1-indexed) nodes assigned to ``rack``."""
        return tuple(i + 1 for i, r in enumerate(self.racks) if r == rack)

    @property
    def max_rack_size(self) -> int:
        return max(len(self.nodes_in(r)) for r in set(self.racks))

    def survives_rack_loss(self, k: int) -> bool:
        """True if losing ANY single rack leaves >= k nodes alive — every
        rack holds at most n - k nodes."""
        return self.max_rack_size <= self.n_nodes - k


def rack_layout(n_nodes: int, n_racks: int) -> RackLayout:
    """Round-robin the nodes across ``n_racks`` failure domains (rack
    sizes differ by at most one)."""
    if n_racks < 1:
        raise ValueError("need at least one rack")
    return RackLayout(n_nodes=n_nodes,
                      racks=tuple(i % n_racks for i in range(n_nodes)))


def rotate_placement(layout: RackLayout, n_shares: int,
                     stripe: int) -> tuple[int, ...]:
    """Physical nodes (1-indexed) holding a stripe's ``n_shares`` shares.

    Share j of stripe t lands on node ``(t + j) mod n_nodes + 1``: stripes
    rotate around the node ring so load (and, after a node failure, the
    per-stripe loss count) spreads evenly; the stripe manager checks at
    construction that ``max_shares_per_rack`` stays within the code's
    n - k budget for every rotation phase.
    """
    if n_shares > layout.n_nodes:
        raise ValueError(f"cannot place {n_shares} distinct shares on "
                         f"{layout.n_nodes} nodes")
    return tuple((stripe + j) % layout.n_nodes + 1 for j in range(n_shares))


def max_shares_per_rack(layout: RackLayout,
                        placement: Sequence[int]) -> int:
    """Largest number of a stripe's shares co-located in one rack — what a
    correlated rack loss erases of that stripe."""
    counts: dict[int, int] = {}
    for node in placement:
        r = layout.rack_of(node)
        counts[r] = counts.get(r, 0) + 1
    return max(counts.values()) if counts else 0


# ------------------------------------------------------------------- trees
class TreeDef:
    """The structure of a flattened tree: rebuilds it from its leaves.

    ``str()`` follows the reference's ``PyTreeDef(...)`` notation for
    dicts, lists, tuples, named tuples and None."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta=None, children=()):
        self.kind = kind            # leaf | none | dict | odict | list
        self.meta = meta            #   | tuple | namedtuple
        self.children = tuple(children)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves: Sequence) -> Any:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"too many leaves for {self}")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            x = next(it, _END)
            if x is _END:
                raise ValueError(f"too few leaves for {self}")
            return x
        if self.kind == "none":
            return None
        vals = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, vals))
        if self.kind == "odict":
            return OrderedDict(zip(self.meta, vals))
        if self.kind == "list":
            return vals
        if self.kind == "tuple":
            return tuple(vals)
        return self.meta(*vals)     # namedtuple

    def _repr(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        kids = [c._repr() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}"
                                   for k, v in zip(self.meta, kids)) + "}"
        if self.kind == "odict":
            return (f"CustomNode(OrderedDict[{tuple(self.meta)!r}], "
                    f"[{', '.join(kids)}])")
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") \
                + ")"
        return (f"CustomNode(namedtuple[{self.meta.__name__}], "
                f"[{', '.join(kids)}])")

    def __repr__(self) -> str:
        return f"PyTreeDef({self._repr()})"

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and repr(self) == repr(other)

    def __hash__(self) -> int:
        return hash(repr(self))


_END = object()


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """(leaves, treedef), in the reference's leaf order: a plain dict's
    keys sorted, an OrderedDict's and every sequence's in order, None a
    node without leaves."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _flatten(x, leaves: list) -> TreeDef:
    if x is None:
        return TreeDef("none")
    if isinstance(x, OrderedDict):
        keys = list(x)
        return TreeDef("odict", keys, [_flatten(x[k], leaves) for k in keys])
    if isinstance(x, dict):
        keys = sorted(x)
        return TreeDef("dict", keys, [_flatten(x[k], leaves) for k in keys])
    if isinstance(x, tuple) and hasattr(type(x), "_fields"):
        return TreeDef("namedtuple", type(x),
                       [_flatten(v, leaves) for v in x])
    if isinstance(x, (list, tuple)):
        return TreeDef("list" if isinstance(x, list) else "tuple", None,
                       [_flatten(v, leaves) for v in x])
    leaves.append(x)
    return TreeDef("leaf")


def _leaf_bytes(leaf) -> tuple[bytes, str, list]:
    """(raw bytes, dtype name, shape) of one leaf, as the reference's
    ``np.asarray(leaf)`` writes it; bfloat16 tensors as their 16-bit
    patterns; a Sharded leaf gathered whole first."""
    if isinstance(leaf, Sharded):
        leaf = leaf.gather()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).cpu().numpy().tobytes(), "bfloat16",
                    list(t.shape))
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def pytree_to_bytes(tree: Any) -> tuple[bytes, TreeDef, list[dict]]:
    """(payload, treedef, metas) of ``tree``.  Raises ValueError for a
    leaf of object dtype before returning anything: its raw bytes are
    pointers, which no read could turn back into the leaf."""
    leaves, treedef = tree_flatten(tree)
    metas, chunks = [], []
    for leaf in leaves:
        raw, dtype, shape = _leaf_bytes(leaf)
        if dtype == "object":
            raise ValueError("a tree leaf of object dtype cannot be stored: "
                             "its bytes are pointers, not values")
        metas.append({"dtype": dtype, "shape": shape, "nbytes": len(raw)})
        chunks.append(raw)
    return b"".join(chunks), treedef, metas


def bytes_to_leaves(payload: bytes, metas: list[dict],
                    device=None) -> list:
    """The leaves of ``payload``: numeric and boolean leaves as tensors on
    ``device`` (None: the card; a bfloat16 leaf as a bfloat16 tensor, a
    byte-swapped leaf such as ``>i4`` as a native-order tensor of equal
    values).  A leaf of a dtype torch has no tensor for (strings, bytes,
    datetimes) comes back as the numpy array the reference returns."""
    device = resolve_device(device)
    leaves, off = [], 0
    for m in metas:
        raw = payload[off: off + m["nbytes"]]
        off += m["nbytes"]
        if m["dtype"] == "bfloat16":
            arr = np.frombuffer(raw, dtype=np.int16).reshape(m["shape"])
            leaves.append(torch.from_numpy(arr.copy()).view(
                torch.bfloat16).to(device))
            continue
        dt = np.dtype(m["dtype"])
        arr = np.frombuffer(raw, dtype=dt).reshape(m["shape"])
        if dt.kind not in "biufc":
            leaves.append(arr.copy())
            continue
        arr = arr.astype(dt.newbyteorder("="))      # a native-order copy
        leaves.append(torch.from_numpy(arr).to(device))
    return leaves


def pytree_to_blocks(tree: Any, n: int, p: int = gf.DEFAULT_P,
                     ) -> tuple[np.ndarray, TreeDef, TreeSpec]:
    """Serialize a tree into (n, S) GF(p) data blocks a_0..a_{n-1}."""
    payload, treedef, metas = pytree_to_bytes(tree)
    sym = gf.bytes_to_symbols(payload, p)
    pad = (-len(sym)) % n
    sym = np.pad(sym, (0, pad))
    blocks = sym.reshape(n, -1).astype(np.int32)
    spec = TreeSpec(treedef_repr=str(treedef), leaves=metas,
                    total_bytes=len(payload), n_blocks=n,
                    block_symbols=blocks.shape[1])
    return blocks, treedef, spec


def blocks_to_pytree(blocks: np.ndarray, treedef: TreeDef, spec: TreeSpec,
                     device=None) -> Any:
    """Inverse of pytree_to_blocks: leaves as tensors on ``device`` (None:
    the card).  Pure byte reads for systematic blocks."""
    sym = np.asarray(blocks).reshape(-1)
    payload = gf.symbols_to_bytes(sym)[: spec.total_bytes]
    return treedef.unflatten(bytes_to_leaves(payload, spec.leaves, device))


__all__ = ["TreeSpec", "TreeDef", "RackLayout", "rack_layout",
           "rotate_placement", "max_shares_per_rack", "tree_flatten",
           "pytree_to_bytes", "bytes_to_leaves", "pytree_to_blocks",
           "blocks_to_pytree"]
