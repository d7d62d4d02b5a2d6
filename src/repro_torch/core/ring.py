"""Ring-native MSR encode (the port of ``repro.core.ring``).

The circulant structure of M means every redundancy block is a
combination of the NEXT k data blocks: node i (0-indexed) computes

    r_{i+1} = sum_{t=1..k} c_{k+1-t} * a_{(i+t) mod n}

so encode = k rounds of *neighbour shift + scale + accumulate*: each round
every node forwards one block to its LEFT neighbour (j -> j-1), i.e.
blocks flow rightward one hop per round.  Total traffic: k blocks per
link, all neighbour-wise; no gather, no all-to-all.

The reference runs it as ``shard_map`` + ``jax.lax.ppermute`` over a 1-D
``storage`` mesh axis.  The port keeps one controller: row i lives on the
i-th device along the axis, and a hop is an explicit copy of a tensor to
its neighbour's device (:func:`~repro_torch.sharding.mesh.move_to`) — a
peer copy over NVLink between two cards, no copy at all where a device repeats
(a ring of n nodes on one card).  The multiply-accumulate is plain
elementwise int32 torch on each node's device, as the reference's is jnp
inside the ``shard_map`` body: no kernel of its own.

Repair is point-to-point (d = k+1 direct fetches) and lives at the
checkpoint layer, where its byte count is the paper's gamma (eq. 7).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch.sharding.mesh import axis_devices, move_to

from .circulant import CodeSpec


@dataclasses.dataclass
class LinkTraffic:
    """What crossed each ring link (sender, receiver) during an encode:
    blocks and bytes.  Filled by :func:`ring_encode` when passed in."""
    blocks: dict = dataclasses.field(default_factory=lambda: defaultdict(int))
    bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    def send(self, src: int, dst: int, t: torch.Tensor) -> None:
        self.blocks[(src, dst)] += 1
        self.bytes[(src, dst)] += t.numel() * t.element_size()


def ring_encode(data, spec: CodeSpec, mesh, axis: str = "storage",
                byte_wire: bool | None = None,
                traffic: LinkTraffic | None = None) -> torch.Tensor:
    """data: (n, S) symbols, row i on storage node i (the i-th device
    along ``axis`` of ``mesh``) -> redundancy (n, S) int32, row i =
    r_{i+1}, computed on node i with neighbour-only communication and
    returned on the first node's device.

    byte_wire: send uint8 payloads (4x less wire than int32 symbols).
    Valid when every data symbol < 256: automatic for p <= 256; for
    p = 257 the caller opts in when the blocks are systematic raw bytes
    (always true for the checkpoint layer's data blocks).  ``traffic``,
    when given, counts the blocks and bytes sent over each link."""
    n = spec.n
    devs = axis_devices(mesh, axis)
    if len(devs) != n:
        raise ValueError(f"mesh axis {axis}={len(devs)} != n={n}")
    if byte_wire is None:
        byte_wire = spec.p <= 256
    wire = torch.uint8 if byte_wire else torch.int32
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.asarray(data))
    if data.dim() != 2 or data.shape[0] != n:
        raise ValueError(f"data must be ({n}, S), got {tuple(data.shape)}")
    if data.dtype.is_floating_point or data.dtype == torch.bool:
        raise TypeError(f"GF symbols must be integers, got {data.dtype}")
    c, p, k = [int(x) for x in spec.c], spec.p, spec.k

    def node_block(i):                 # a_i reduced mod p, on node i
        row = move_to(data[i], devs[i])
        if row.dtype != torch.int32:
            row = torch.remainder(row.to(torch.int64), p)
        return torch.remainder(row, p).to(wire)

    bufs = [node_block(i) for i in range(n)]
    accs = [torch.zeros(b.shape, dtype=torch.int32, device=b.device)
            for b in bufs]
    for t in range(1, k + 1):
        sent = []
        for i in range(n):             # node (i+1) sends LEFT to node i
            src = (i + 1) % n
            if traffic is not None:
                traffic.send(src, i, bufs[src])
            sent.append(move_to(bufs[src], devs[i]))
        bufs = sent                    # bufs[i] now holds a_{i+t}
        for i in range(n):             # coefficient c_{k+1-t}
            accs[i].add_(bufs[i].to(torch.int32),
                         alpha=c[k - t]).remainder_(p)
    out = torch.empty((n, accs[0].shape[-1]), dtype=torch.int32,
                      device=devs[0])
    for i, acc in enumerate(accs):
        out[i].copy_(acc, non_blocking=out.is_cuda)
    return out


def ring_encode_reference(data, spec: CodeSpec, device=None) -> torch.Tensor:
    """Oracle: the code layer's encode (``DoubleCirculantMSR.encode``) on
    ``device`` (None is the card)."""
    from .msr import DoubleCirculantMSR
    return DoubleCirculantMSR(spec, device=device).encode(data)


def ring_link_traffic_blocks(spec: CodeSpec) -> int:
    """Blocks crossing each ring link during encode: k (one per round)."""
    return spec.k


__all__ = ["LinkTraffic", "ring_encode", "ring_encode_reference",
           "ring_link_traffic_blocks"]
