"""Placement of trees over a :class:`~repro_torch.launch.mesh.DeviceMesh`:
the port's counterpart of ``jax.sharding.NamedSharding``,
``jax.device_put(tree, shardings)`` and the argument placement of
``jax.jit(in_shardings=...)``.

A leaf laid out over a mesh is a :class:`Sharded`: one tensor per mesh
position, each the block of the full tensor that the position's spec
entry names, on that position's device.  A spec entry of several axes
splits its dim by their product, the first axis major (as GSPMD).  An
axis a spec does not name replicates: each position along it holds the
same block — one copy per position, as GSPMD keeps it.  Positions that
hold the same block on the same ``torch.device`` (a mesh over
``[cuda:0] * 4``, or ``["cpu"] * 8`` in the tests) share ONE tensor: the
storage of a replicated block is then held once per device, while
:func:`device_bytes` still reports each position's bytes as the policy
lays them out.

Collectives are explicit and run in mesh order under one controller
(`sharding/parallel.py` says why):

* a gather (:meth:`Sharded.gather`, :func:`assemble`) concatenates the
  blocks covering a region onto the consuming device;
* an all-reduce (:func:`all_reduce`) sums partials in mesh order on the
  first one's device;
* a reduce-scatter is that sum cut (autograd's backward of a gather).

Autograd runs through the copies, concatenations and sums, so a backward
pass produces the reverse collectives itself.  :data:`traffic` counts
the bytes that cross between positions, gathers and reduces apart.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.sharding.mesh import move_to
from repro_torch.sharding.policy import tree_map_with_path


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): what
    :func:`place` lays a leaf out by."""
    mesh: Any
    spec: tuple


@dataclasses.dataclass
class Traffic:
    """Bytes moved between mesh positions since the last :meth:`reset`:
    ``gather_bytes`` (blocks and broadcasts read by another position)
    and ``reduce_bytes`` (partials summed onto another position), and
    the number of such moves, ``gathers`` and ``reduces``."""
    gather_bytes: int = 0
    reduce_bytes: int = 0
    gathers: int = 0
    reduces: int = 0

    def reset(self) -> None:
        self.gather_bytes = self.reduce_bytes = 0
        self.gathers = self.reduces = 0


traffic = Traffic()


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def full_spec(spec: tuple, ndim: int) -> tuple:
    """``spec`` padded with None to ``ndim`` entries."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the {ndim} "
                         f"dims of its leaf")
    return spec + (None,) * (ndim - len(spec))


def positions(mesh) -> list[tuple[int, ...]]:
    """Every mesh position, in mesh (row-major) order."""
    return list(np.ndindex(*mesh.devices.shape))


def position_device(mesh, pos) -> torch.device:
    return torch.device(mesh.devices[pos])


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Sharded:
    """One tensor of ``shape`` laid out over ``mesh`` by ``spec``:
    ``shards[pos]`` is position ``pos``'s block, on its device.
    Positions holding the same block on the same device share one
    tensor object.  An intermediate may leave positions out (each block
    held somewhere); everything :func:`place` or :meth:`relayout` returns
    covers every position."""

    __slots__ = ("mesh", "spec", "shape", "dtype", "shards")

    def __init__(self, mesh, spec: tuple, shape, dtype, shards: dict):
        self.mesh = mesh
        self.spec = full_spec(spec, len(shape))
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Sharded(shape={tuple(self.shape)}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")

    # ------------------------------------------------------------ layout
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The device of the first position that holds a block."""
        return next(iter(self.shards.values())).device

    def grid(self) -> tuple[int, ...]:
        """Blocks along each dim."""
        return tuple(math.prod(self.mesh.shape[a] for a in _entry_axes(e))
                     for e in self.spec)

    def block(self, pos) -> tuple[int, ...]:
        """Position ``pos``'s block index along each dim: its coordinates
        on the entry's axes read as one number, the first axis major."""
        coords = dict(zip(self.mesh.shape, pos))
        out = []
        for e in self.spec:
            i = 0
            for a in _entry_axes(e):
                i = i * self.mesh.shape[a] + coords[a]
            out.append(i)
        return tuple(out)

    def check(self) -> None:
        """Raise ValueError unless the spec divides the shape."""
        for n, g, e in zip(self.shape, self.grid(), self.spec):
            if n % g:
                raise ValueError(f"spec {self.spec} does not divide shape "
                                 f"{tuple(self.shape)}: entry {e!r} splits "
                                 f"{n} into {g}")

    def block_shape(self) -> tuple[int, ...]:
        return tuple(n // g for n, g in zip(self.shape, self.grid()))

    def block_nbytes(self) -> int:
        return math.prod(self.block_shape()) * _itemsize(self.dtype)

    def holders(self) -> dict:
        """block index -> [(pos, tensor)] of every position holding it,
        in mesh order."""
        out: dict = {}
        for pos, t in self.shards.items():
            out.setdefault(self.block(pos), []).append((pos, t))
        return out

    def unique(self) -> list[torch.Tensor]:
        """The distinct shard tensors, in the mesh order of their first
        holder."""
        seen, out = set(), []
        for t in self.shards.values():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    # -------------------------------------------------------------- maps
    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """``fn`` over the shards (and those of ``others``, laid out
        alike), once per distinct tuple of shard tensors; the results
        share as the inputs do.  ``fn`` must keep each shard's shape."""
        return self.map_many(lambda *xs: (fn(*xs),), *others)[0]

    def map_many(self, fn: Callable, *others: "Sharded", spec=None,
                 shape=None) -> tuple:
        """:meth:`map` for an ``fn`` returning a tuple: one Sharded per
        element, each of this layout (or of ``spec`` and ``shape`` where
        ``fn`` changes them)."""
        memo: dict = {}
        outs: Optional[list] = None
        for pos, t in self.shards.items():
            args = (t,) + tuple(o.shards[pos] for o in others)
            key = tuple(id(a) for a in args)
            if key not in memo:
                memo[key] = fn(*args)
            res = memo[key]
            if outs is None:
                outs = [{} for _ in res]
            for d, r in zip(outs, res):
                d[pos] = r
        spec = self.spec if spec is None else spec
        shape = self.shape if shape is None else shape
        return tuple(Sharded(self.mesh, spec, shape,
                             next(iter(d.values())).dtype, d)
                     for d in outs)

    def to(self, dtype: torch.dtype) -> "Sharded":
        if dtype == self.dtype:
            return self
        return self.map(lambda t: t.to(dtype))

    def __getitem__(self, i: int) -> "Sharded":
        """Index ``i`` of dim 0 (a cycle of a stacked leaf): a view of
        each shard where dim 0 is not split, else from the blocks that
        hold it."""
        if not isinstance(i, int):
            raise TypeError("a Sharded indexes only its leading dim by int")
        src = self if self.spec[0] is None else self.relayout(
            (None,) + self.spec[1:])
        return src.map_many(lambda t: (t[i],), spec=src.spec[1:],
                            shape=src.shape[1:])[0]

    # -------------------------------------------------------- collectives
    def gather(self, device=None) -> torch.Tensor:
        """The full tensor on ``device`` (default: the first holder's)."""
        device = self.device if device is None else torch.device(device)
        return assemble(self, [(0, n) for n in self.shape], device)

    def relayout(self, spec: tuple) -> "Sharded":
        """This tensor laid out by ``spec``: each position's block
        assembled from the blocks covering it (itself where a position
        already holds it)."""
        spec = full_spec(spec, self.ndim)
        if spec == self.spec and len(self.shards) == self.mesh.devices.size:
            return self
        return self._laid(spec, self.shape)

    def take(self, dim: int, lo: int, hi: int) -> "Sharded":
        """Indices [lo, hi) of ``dim`` laid out by this spec: each
        position's block of the slice assembled from the blocks holding
        it (a microbatch cut from the global batch, re-laid over the
        batch axes)."""
        shape = list(self.shape)
        shape[dim] = hi - lo
        return self._laid(self.spec, shape, {dim: lo})

    def _laid(self, spec: tuple, shape, offset: Optional[dict] = None
              ) -> "Sharded":
        """A Sharded of ``shape`` laid out by ``spec`` whose element at
        index i is this one's at i + ``offset`` (dim -> start)."""
        out = Sharded(self.mesh, spec, shape, self.dtype, {})
        out.check()
        bs = out.block_shape()
        offset = offset or {}
        memo: dict = {}
        for pos in positions(self.mesh):
            blk = out.block(pos)
            dev = position_device(self.mesh, pos)
            key = (blk, dev)
            if key not in memo:
                region = [(b * s + offset.get(d, 0),
                           (b + 1) * s + offset.get(d, 0))
                          for d, (b, s) in enumerate(zip(blk, bs))]
                memo[key] = assemble(self, region, dev, pos)
            out.shards[pos] = memo[key]
        return out


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def assemble(src: Sharded, region, device: torch.device,
             pos=None) -> torch.Tensor:
    """The part of ``src`` inside ``region`` (per dim ``(lo, hi)``) on
    ``device``: the covering blocks cut and concatenated (each read from
    ``pos`` itself when it holds it, else a holder on ``device``, else
    the first holder).  A region that is one block held on ``device``
    comes back as that tensor, uncopied.  Bytes read from another
    position than ``pos`` count as gathered."""
    bs = src.block_shape()
    holders = src.holders()
    ranges = [range(lo // s, -(-hi // s)) for (lo, hi), s in zip(region, bs)]
    pieces = []
    for blk in itertools.product(*ranges):
        cands = holders[blk]
        hold_pos, t = next(
            (c for c in cands if c[0] == pos),
            next((c for c in cands if c[1].device == device), cands[0]))
        for d, ((lo, hi), s, b) in enumerate(zip(region, bs, blk)):
            a, z = max(lo, b * s) - b * s, min(hi, (b + 1) * s) - b * s
            if (a, z) != (0, s):
                t = t.narrow(d, a, z - a)
        if pos is not None and hold_pos != pos:
            traffic.gather_bytes += nbytes(t)
            traffic.gathers += 1
        pieces.append(move_to(t, device))
    # concatenate the grid of pieces, the last dim first
    shape = [len(r) for r in ranges]
    for d in reversed(range(len(shape))):
        if shape[d] > 1:
            step = shape[d]
            pieces = [torch.cat(pieces[i:i + step], dim=d)
                      for i in range(0, len(pieces), step)]
    return pieces[0]


def all_reduce(partials: list[torch.Tensor]) -> torch.Tensor:
    """The sum of ``partials`` in their (mesh) order, on the first one's
    device and in its dtype; the others count as reduced bytes."""
    dev = partials[0].device
    acc = partials[0]
    for p in partials[1:]:
        traffic.reduce_bytes += nbytes(p)
        traffic.reduces += 1
        acc = acc + move_to(p, dev)
    return acc


def broadcast(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` for another position (counted as gathered)."""
    traffic.gather_bytes += nbytes(x)
    traffic.gathers += 1
    return move_to(x, device)


# ------------------------------------------------------------ trees
def _map_pairs(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over ``tree``, ``other`` of the same
    structure with its own leaves (``NamedSharding``s)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, _map_pairs(fn, v, other[k]))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_map_pairs(fn, v, o)
                            for v, o in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_pairs(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def shard(x: torch.Tensor, mesh, spec: tuple) -> Sharded:
    """``x`` laid out over ``mesh`` by ``spec``: each position's block
    copied onto its device (one copy per block and device)."""
    if isinstance(x, Sharded):
        return x.relayout(spec)
    out = Sharded(mesh, spec, x.shape, x.dtype, {})
    out.check()
    bs = out.block_shape()
    memo: dict = {}
    for pos in positions(mesh):
        blk = out.block(pos)
        dev = position_device(mesh, pos)
        if (blk, dev) not in memo:
            piece = x
            for d, (b, s) in enumerate(zip(blk, bs)):
                piece = piece.narrow(d, b * s, s)
            t = torch.empty(bs, dtype=x.dtype, device=dev)
            t.copy_(piece)
            memo[(blk, dev)] = t
        out.shards[pos] = memo[(blk, dev)]
    return out


def place(tree: Any, named_tree: Any) -> Any:
    """``tree`` with each tensor leaf laid out by the
    :class:`NamedSharding` at the same place in ``named_tree``
    (``jax.device_put(tree, shardings)``)."""
    return _map_pairs(
        lambda x, ns: shard(x, ns.mesh, ns.spec)
        if isinstance(x, (torch.Tensor, Sharded)) else x, tree, named_tree)


def _map_leaves(fn: Callable, tree: Any) -> Any:
    return tree_map_with_path(lambda _, x: fn(x), tree)


def gather(tree: Any, device=None) -> Any:
    """``tree`` with each :class:`Sharded` leaf made whole on ``device``
    (default: the leaf's first holder's device)."""
    return _map_leaves(lambda x: x.gather(device)
                       if isinstance(x, Sharded) else x, tree)


def device_bytes(tree: Any) -> dict:
    """Bytes of the :class:`Sharded` leaves of ``tree`` that each mesh
    position holds, as the specs lay them out (a block shared by
    positions on one device counts at each)."""
    out: dict = {}

    def add(x):
        if isinstance(x, Sharded):
            for pos in positions(x.mesh):
                out[pos] = out.get(pos, 0) + x.block_nbytes()
        return x
    _map_leaves(add, tree)
    return out


def stack(parts: list[Sharded]) -> Sharded:
    """``torch.stack`` of Sharded tensors of one layout, on a new
    unsplit leading dim."""
    p0 = parts[0]
    memo: dict = {}
    shards = {}
    for pos in p0.shards:
        ts = [p.shards[pos] for p in parts]
        key = tuple(id(t) for t in ts)
        if key not in memo:
            memo[key] = torch.stack(ts)
        shards[pos] = memo[key]
    return Sharded(p0.mesh, (None,) + p0.spec, (len(parts),) + tuple(p0.shape),
                   p0.dtype, shards)


def leafwise(fn: Callable, x, *others):
    """``fn`` on a tensor leaf, or shard by shard on a Sharded one (with
    ``others`` laid out alike)."""
    if isinstance(x, Sharded):
        return x.map(fn, *others)
    return fn(x, *others)


def reduce_copies(x: Sharded) -> Sharded:
    """Copies of one block on distinct devices summed in mesh order (an
    all-reduce over the axes the spec replicates), the sum on each of
    their devices; a block held once, or on one device, as it is."""
    out = {}
    for hs in x.holders().values():
        distinct = list({id(t): t for _, t in hs}.values())
        total = all_reduce(distinct) if len(distinct) > 1 else distinct[0]
        per_dev = {total.device: total}
        for pos, t in hs:
            if t.device not in per_dev:
                per_dev[t.device] = broadcast(total, t.device)
            out[pos] = per_dev[t.device]
    return Sharded(x.mesh, x.spec, x.shape, x.dtype, out)


__all__ = ["NamedSharding", "Sharded", "Traffic", "traffic", "place",
           "leafwise", "reduce_copies",
           "gather", "device_bytes", "shard", "assemble", "all_reduce",
           "broadcast", "stack", "positions", "position_device", "full_spec"]
