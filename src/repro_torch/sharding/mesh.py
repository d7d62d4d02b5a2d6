"""Stream-axis device mesh + declarative sharding rules (the port of
``repro.sharding.mesh``).

Every hot-path GF op — circulant encode, the decode-side matmul, fused
regenerate, batched regenerate, per-element batched matmul — has one
large *stream* axis (symbol columns), and the double-circulant structure
makes every op column-local over it: split the stream, replicate the tiny
static operands, and each device computes its window with zero
cross-device GF arithmetic.

The reference runs one Python controller over a ``jax.sharding.Mesh`` and
lowers each op through ``shard_map``.  The port keeps the single
controller and says in torch's terms what ``shard_map`` did:

* :class:`StreamMesh` — an explicit, ordered tuple of ``torch.device``s
  along the ``"stream"`` axis.  A device may repeat (``["cpu"] * 4`` in
  the CPU tests, ``[cuda:0] * 8`` on one card): torch has no
  ``--xla_force_host_platform_device_count``, and a repeated device runs
  its shards one after another on its current stream;
* :class:`ShardingRule` + :func:`register_rule` / :func:`get_rule` — the
  registry mapping op name -> per-operand specs.  A spec is a plain tuple
  of axis names and ``None`` (:func:`P`), one entry per leading dim, as a
  ``PartitionSpec`` is;
* :func:`shard_body` — wraps a per-shard op: splits every stream operand
  into ``mesh.size`` column windows of ``shard_extent(s)`` (the last one
  ragged, possibly empty), replicates the rest to each shard's device,
  runs the op once per non-empty shard and assembles the output on the
  caller's tensor.  A shard on the output's own device reads its window
  of the operands and writes its window of the output in place (the
  kernels take a row pitch); a shard elsewhere gets its operands copied
  to it and its result copied back;
* :func:`use_mesh` / :func:`current_mesh` — the ambient-mesh scope, so
  stores, checkpointers and codes built inside ``use_mesh(...)`` inherit
  the mesh without a keyword through every layer.

``torch.distributed`` is not used: NCCL cannot put two ranks on one GPU,
and the planner's contract (numpy in, numpy out, one controller) has no
ranks.  A copy between two cards of one host is a peer copy over NVLink.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.device import canonical_device

STREAM_AXIS = "stream"


class MeshConfigError(ValueError):
    """Invalid mesh construction: non-integer / non-positive axis size,
    or more shards requested than devices exist."""


def P(*axes) -> tuple:
    """A spec: one axis name (or None, replicated) per leading dim of an
    operand; ``P()`` replicates the whole operand."""
    return tuple(axes)


class StreamMesh:
    """A validated 1-D device mesh over the ``"stream"`` axis.

    Parameters
    ----------
    n_shards : int, optional
        Mesh size (shards along the stream axis).  ``None`` takes every
        device of the pool.
    devices : sequence of torch devices (or names), optional
        The pool to draw from, in order; it may repeat a device.  Default:
        the host's CUDA cards, ``cuda:0 .. cuda:{count-1}``.  The mesh
        takes the first ``n_shards`` of them.

    Raises
    ------
    MeshConfigError
        If ``n_shards`` is not a positive integer or exceeds the pool;
        the message names the fix (``devices=``).
    """

    def __init__(self, n_shards: Optional[int] = None, *, devices=None):
        if devices is None:
            pool = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
            where = "CUDA cards"
        else:
            pool = [canonical_device(d) for d in devices]
            where = "devices given"
        if n_shards is None:
            if not pool:
                raise MeshConfigError(
                    f"mesh axis '{STREAM_AXIS}' has no devices: this host "
                    f"has no CUDA card; pass devices= (e.g. "
                    f"devices=['cpu'] * 4)")
            n_shards = len(pool)
        if isinstance(n_shards, bool) or not isinstance(n_shards, int):
            raise MeshConfigError(
                f"mesh axis '{STREAM_AXIS}' size must be an int, got "
                f"{n_shards!r} ({type(n_shards).__name__})")
        if n_shards < 1:
            raise MeshConfigError(
                f"mesh axis '{STREAM_AXIS}' size must be >= 1, got "
                f"{n_shards}")
        if n_shards > len(pool):
            raise MeshConfigError(
                f"mesh axis '{STREAM_AXIS}' wants {n_shards} devices but "
                f"only {len(pool)} {where}; pass devices= to place shards "
                f"explicitly (a device may repeat, e.g. "
                f"devices=[torch.device('cuda', 0)] * {n_shards})")
        self.size = n_shards
        self.devices = tuple(pool[:n_shards])

    # ------------------------------------------------------------- identity
    @property
    def is_trivial(self) -> bool:
        """A 1-shard mesh carries no sharding: callers use the plain
        unsharded path."""
        return self.size == 1

    def key(self) -> tuple:
        """Registry identity: two meshes over the same devices, in the
        same order and with the same repeats, share planners."""
        return (STREAM_AXIS, tuple(str(d) for d in self.devices))

    # -------------------------------------------------------------- windows
    def shard_extent(self, s: int) -> int:
        """Per-shard stream extent before bucketing: ceil(s / size)."""
        return -(-int(s) // self.size)

    def windows(self, s: int) -> list[tuple[int, int]]:
        """Each shard's column window [lo, hi) of a stream of ``s``
        symbols: ``shard_extent(s)`` wide, the last ones ragged or empty
        (lo == hi) when s is not a multiple of the size."""
        e = self.shard_extent(s)
        return [(min(i * e, s), min((i + 1) * e, s))
                for i in range(self.size)]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"StreamMesh(size={self.size}, devices={self.key()[1]})"


MeshLike = Union[StreamMesh, int, None]


def as_stream_mesh(mesh: MeshLike) -> Optional[StreamMesh]:
    """Coerce user input: None passes through, an int builds a
    StreamMesh of that size over the CUDA cards, anything else must
    already be one."""
    if mesh is None or isinstance(mesh, StreamMesh):
        return mesh
    if isinstance(mesh, bool):
        raise MeshConfigError(f"mesh must be a StreamMesh, int or None, "
                              f"got {mesh!r}")
    if isinstance(mesh, int):
        return StreamMesh(mesh)
    raise MeshConfigError(f"mesh must be a StreamMesh, int or None, got "
                          f"{type(mesh).__name__}")


def mesh_device(mesh: Optional[StreamMesh], device) -> Optional[torch.device]:
    """The device a meshed planner or code computes on: the mesh's first
    device.  ``device=None`` follows the mesh; another device raises.
    Without a mesh, ``device`` is returned as given."""
    if mesh is None:
        return device
    home = mesh.devices[0]
    if device is not None and canonical_device(device) != home:
        raise MeshConfigError(
            f"device={device!r} is not the mesh's first device {home}; "
            f"pass device=None to follow the mesh")
    return home


def axis_devices(mesh, axis: str) -> list[torch.device]:
    """The devices along ``axis`` of a named mesh (``.shape`` a dict from
    axis name to size, ``.devices`` an array), at index 0 of every other
    axis: the ring a collective over ``axis`` runs on."""
    names = list(mesh.shape)
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {names}")
    devs = np.asarray(mesh.devices, dtype=object)
    devs = np.moveaxis(devs, names.index(axis), 0).reshape(
        mesh.shape[axis], -1)
    return [canonical_device(d) for d in devs[:, 0]]


# ------------------------------------------------------------ rule registry
@dataclasses.dataclass(frozen=True)
class ShardingRule:
    """Declarative per-op layout: how each operand and the output split
    over the stream axis.  ``in_specs[i]`` matches positional operand i
    of the planned op; replicated operands use ``P()``.  An operand that
    is a tuple of row sources takes its spec element by element."""
    op: str
    in_specs: tuple
    out_specs: tuple
    doc: str = ""


_RULES: dict[str, ShardingRule] = {}


def register_rule(rule: ShardingRule, *, override: bool = False) -> None:
    if rule.op in _RULES and not override:
        raise ValueError(f"sharding rule for op {rule.op!r} already "
                         f"registered (pass override=True to replace)")
    _RULES[rule.op] = rule


def get_rule(op: str) -> ShardingRule:
    try:
        return _RULES[op]
    except KeyError:
        raise KeyError(f"no sharding rule registered for op {op!r}; "
                       f"known ops: {sorted(_RULES)}") from None


def known_rules() -> tuple[str, ...]:
    return tuple(sorted(_RULES))


# The five planned GF ops (exec/plan.py), with the reference's specs and
# docs.  All are column-local over the stream (last) axis, so the rules
# are pure data-parallel splits: no shard reads another shard's columns.
register_rule(ShardingRule(
    "matmul",
    in_specs=(P(), P(None, STREAM_AXIS)),
    out_specs=P(None, STREAM_AXIS),
    doc="decode-side (mat @ blocks) mod p: small mat replicated, the "
        "(rows, S) block operand and product split over S"))
register_rule(ShardingRule(
    "circulant_encode",
    in_specs=(P(None, STREAM_AXIS),),
    out_specs=P(None, STREAM_AXIS),
    doc="eq. (2) encode: (n, S) data split over S; coefficients are "
        "static in the kernel"))
register_rule(ShardingRule(
    "regenerate",
    in_specs=(P(), P(STREAM_AXIS), P(None, STREAM_AXIS)),
    out_specs=P(None, STREAM_AXIS),
    doc="fused newcomer kernel: (2, k+1) repair matrix replicated, "
        "r_prev (S,) and helper data (k, S) split over S"))
register_rule(ShardingRule(
    "regenerate_batch",
    in_specs=(P(), P(None, STREAM_AXIS), P(None, None, STREAM_AXIS)),
    out_specs=P(None, None, STREAM_AXIS),
    doc="vmapped fused regeneration: batch (F) axis replicated per "
        "device, stream split over S"))
register_rule(ShardingRule(
    "matmul_batch",
    in_specs=(P(), P(None, None, STREAM_AXIS)),
    out_specs=P(None, None, STREAM_AXIS),
    doc="per-element batched matmul (product-matrix batched regen, "
        "DESIGN.md §16.5): the (F, q, d) matrix stack is replicated, "
        "the (F, d, S) sends and (F, q, S) product split over S"))


def _stream_dim(spec: tuple) -> Optional[int]:
    return spec.index(STREAM_AXIS) if STREAM_AXIS in spec else None


def move_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: itself where it lies there; a copy queued on
    the streams otherwise (a peer copy between cards) when ``device`` is
    a card, and a finished copy when it is the host, whose code reads
    the result at once."""
    if x.device == device:
        return x
    return x.to(device, non_blocking=device.type == "cuda")


def window_to(x: torch.Tensor, dim: int, lo: int, hi: int,
              device: torch.device) -> torch.Tensor:
    """Columns [lo, hi) of ``x`` along ``dim`` on ``device``: a view
    where ``x`` already lies there, else a copy (:func:`move_to`)."""
    return move_to(x.narrow(dim, lo, hi - lo), device)


def shard_body(fn: Callable, op: str, mesh: StreamMesh,
               stage: Callable = window_to) -> Callable:
    """Wrap a per-shard op under the registered rule for ``op``.

    Returns ``run(*operands, out)``: ``out`` is the whole output, on the
    device the result is wanted (the mesh's first device); its extent
    along the rule's stream axis is the stream length s.  For each shard
    with a non-empty window [lo, hi) of ``mesh.windows(s)``, every stream
    operand becomes ``stage(x, dim, lo, hi, device)`` (default
    :func:`window_to`; the planner stages host numpy itself), every
    replicated operand is moved to the shard's device once, and
    ``fn(*shard_operands, out=window)`` writes the output's window in
    place when the shard's device is ``out``'s — else ``fn(...)`` returns
    the shard's result and it is copied into the window.  Empty shards
    launch nothing.  Returns ``out``."""
    rule = get_rule(op)
    out_dim = _stream_dim(rule.out_specs)
    dims = [_stream_dim(spec) for spec in rule.in_specs]

    def run(*operands, out: torch.Tensor) -> torch.Tensor:
        if len(operands) != len(dims):
            raise ValueError(f"{op} takes {len(dims)} operands under its "
                             f"sharding rule, got {len(operands)}")
        home = out.device
        replicas: dict = {}
        for dev, (lo, hi) in zip(mesh.devices, mesh.windows(
                out.shape[out_dim])):
            if hi <= lo:
                continue
            args = []
            for j, (x, d) in enumerate(zip(operands, dims)):
                if d is None:
                    if (j, dev) not in replicas:
                        replicas[(j, dev)] = move_to(x, dev)
                    args.append(replicas[(j, dev)])
                elif isinstance(x, (tuple, list)):
                    args.append(tuple(stage(e, d, lo, hi, dev) for e in x))
                else:
                    args.append(stage(x, d, lo, hi, dev))
            window = out.narrow(out_dim, lo, hi - lo)
            if dev == home:
                fn(*args, out=window)
            else:       # queued onto a card, finished onto the host
                window.copy_(fn(*args), non_blocking=home.type == "cuda")
        return out

    return run


# ------------------------------------------------------------ ambient mesh
_ACTIVE: contextvars.ContextVar[Optional[StreamMesh]] = \
    contextvars.ContextVar("stream_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: MeshLike):
    """Ambient-mesh scope: codes / stores / checkpointers constructed
    inside inherit ``mesh`` (coerced via :func:`as_stream_mesh`) without
    explicit kwargs.  ``use_mesh(None)`` explicitly disables an outer
    ambient mesh for the scope."""
    token = _ACTIVE.set(as_stream_mesh(mesh))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_mesh() -> Optional[StreamMesh]:
    return _ACTIVE.get()


__all__ = [
    "STREAM_AXIS", "MeshConfigError", "P", "StreamMesh", "as_stream_mesh",
    "mesh_device", "axis_devices", "ShardingRule", "register_rule",
    "get_rule", "known_rules", "move_to", "window_to", "shard_body",
    "use_mesh", "current_mesh",
]
