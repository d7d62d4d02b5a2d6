"""Cluster event model and scenario constructors (the port of
``repro.cluster.events``, DESIGN.md §9).

An event stream is the simulator's only input: a time-ordered sequence of
``Event`` records describing what the cluster experiences — node failures
(data lost), transient down/up (data intact, e.g. a rolling restart),
latent sector corruption, scrub passes, straggler onset/recovery, and
client block reads.  The constructors at the bottom compose the streams the
paper's operational story cares about; each returns a :class:`Scenario`
the simulator (and ``benchmarks/bench_cluster.py``) can run unchanged.

Event kinds
-----------
``fail``     node crashes and loses its (a, r) pair — triggers repair
``down``     node unavailable but data intact (restart, network partition)
``up``       a ``down`` node rejoins with its data
``corrupt``  silent sector corruption of stored symbols (latent until scrub)
``scrub``    degraded-read verification pass; flagged nodes are repaired
``slow``     node becomes a straggler (service time x ``factor``)
``read``     client read of one data block (the serving workload)
``delete``   a store object was deleted (key in ``key``) — queue purge feed
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.placement import RackLayout

KINDS = ("fail", "down", "up", "corrupt", "scrub", "slow", "read", "delete")


@dataclasses.dataclass(frozen=True)
class Event:
    """One cluster event.

    Parameters
    ----------
    t : float
        Simulated time the event occurs at.
    kind : str
        One of :data:`KINDS`.
    node : int
        1-indexed node the event targets (0 for cluster-wide kinds).
    block : int
        For ``read``: 0-based data-block index to read.
    factor : float
        For ``slow``: service-time multiplier (1.0 restores full speed).
    where : str
        For ``corrupt``: which stored block to damage, ``"a"`` or ``"r"``.
    positions : tuple of int
        For ``corrupt``: symbol offsets to damage (empty = offset 0).
    key : str
        For ``delete``: the deleted object's store key (the repair
        scheduler drops that key's queued tasks on this event).
    """
    t: float
    kind: str
    node: int = 0
    block: int = 0
    factor: float = 1.0
    where: str = "a"
    positions: tuple[int, ...] = ()
    key: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "delete" and not self.key:
            raise ValueError("delete events carry the deleted store key")
        if self.where not in ("a", "r"):
            raise ValueError(f"corrupt target must be 'a' or 'r', "
                             f"got {self.where!r}")
        if self.kind in ("fail", "down", "up", "corrupt", "slow") \
                and self.node < 1:
            raise ValueError(f"{self.kind} events target a 1-indexed node, "
                             f"got node={self.node}")


# tiny constructors — keep scenario code readable
def fail(t: float, node: int) -> Event:
    return Event(t=t, kind="fail", node=node)


def down(t: float, node: int) -> Event:
    return Event(t=t, kind="down", node=node)


def up(t: float, node: int) -> Event:
    return Event(t=t, kind="up", node=node)


def corrupt(t: float, node: int, where: str = "a",
            positions: Sequence[int] = (0,)) -> Event:
    return Event(t=t, kind="corrupt", node=node, where=where,
                 positions=tuple(int(x) for x in positions))


def scrub(t: float) -> Event:
    return Event(t=t, kind="scrub")


def slow(t: float, node: int, factor: float) -> Event:
    return Event(t=t, kind="slow", node=node, factor=factor)


def read(t: float, block: int) -> Event:
    return Event(t=t, kind="read", block=block)


def delete(t: float, key: str) -> Event:
    return Event(t=t, kind="delete", key=key)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, time-ordered event stream plus its description."""
    name: str
    events: tuple[Event, ...]
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events, key=lambda e: e.t)))

    @property
    def duration(self) -> float:
        return self.events[-1].t if self.events else 0.0


def read_traffic(n_blocks: int, *, t0: float = 0.0, t1: float = 10.0,
                 reads: int = 50, seed: int = 0) -> list[Event]:
    """A uniform client read workload: ``reads`` block reads spread evenly
    over [t0, t1), block indices cycling deterministically from ``seed``
    (no RNG — scenarios must replay identically across runs).  The unit
    stride guarantees every block is visited once ``reads >= n_blocks``,
    whatever ``n_blocks``."""
    if reads <= 0:
        return []
    dt = (t1 - t0) / reads
    return [read(t0 + i * dt, (seed + i) % n_blocks)
            for i in range(reads)]


# --------------------------------------------------------------- scenarios
def victim_reads(victims: Sequence[int], at: float, *,
                 burst: int = 4, window: float = 0.2) -> list[Event]:
    """Reads targeting the failed nodes' blocks right after ``at`` — the
    requests that must be served degraded while repair is in flight."""
    return [read(at + window * (i + 1) / (burst + 1), v - 1)
            for v in victims for i in range(burst)]


def single_node_loss(n: int, *, node: int = 3, at: float = 2.0,
                     horizon: float = 10.0, reads: int = 40,
                     seed: int = 0) -> Scenario:
    """One node crashes mid-traffic; the embedded d = k+1 repair rebuilds
    it while reads of its block transparently degrade."""
    ev = read_traffic(n, t1=horizon, reads=reads, seed=seed)
    ev.append(fail(at, node))
    ev += victim_reads([node], at)
    return Scenario("single_node_loss", tuple(ev),
                    f"node v_{node} fails at t={at} under read traffic")


def multi_node_loss(n: int, k: int, *, failures: int | None = None,
                    at: float = 2.0, horizon: float = 10.0,
                    reads: int = 40, seed: int = 1) -> Scenario:
    """``failures`` nodes (default the full n - k erasure budget) crash at
    the same instant — repaired together by the one-matmul multi-failure
    decode."""
    f = failures if failures is not None else n - k
    if not 1 <= f <= n - k:
        raise ValueError(f"failures must be in 1..{n - k}, got {f}")
    victims = [(2 + 3 * j) % n + 1 for j in range(f)]
    if len(set(victims)) < f:                      # tiny n: fall back dense
        victims = list(range(1, f + 1))
    ev = read_traffic(n, t1=horizon, reads=reads, seed=seed)
    ev += [fail(at, v) for v in victims]
    ev += victim_reads(victims, at, burst=2)
    return Scenario("multi_node_loss", tuple(ev),
                    f"{f} simultaneous failures ({victims}) at t={at}")


def latent_corruption(n: int, *, node: int = 2, at: float = 1.0,
                      scrub_at: float = 5.0, horizon: float = 10.0,
                      reads: int = 30, seed: int = 2) -> Scenario:
    """Silent sector corruption sits latent until a scrub pass re-derives
    every pair through the batched engine, flags the node and repairs it."""
    ev = read_traffic(n, t1=horizon, reads=reads, seed=seed)
    ev.append(corrupt(at, node, "a", positions=(0, 7)))
    ev.append(scrub(scrub_at))
    return Scenario("latent_corruption", tuple(ev),
                    f"v_{node} silently corrupted at t={at}, "
                    f"scrub at t={scrub_at}")


def straggler(n: int, *, node: int = 1, factor: float = 20.0,
              at: float = 1.0, until: float = 6.0, horizon: float = 10.0,
              reads: int = 40, seed: int = 3) -> Scenario:
    """A node slows by ``factor``; reads of its block route around it via
    the degraded path whenever that is faster (straggler mitigation)."""
    ev = read_traffic(n, t1=horizon, reads=reads, seed=seed)
    ev.append(slow(at, node, factor))
    ev.append(slow(until, node, 1.0))
    return Scenario("straggler", tuple(ev),
                    f"v_{node} runs {factor}x slow on [{at}, {until})")


def rack_failure(layout: RackLayout, k: int, *, rack: int = 0,
                 at: float = 2.0, horizon: float = 10.0, reads: int = 40,
                 seed: int = 4) -> Scenario:
    """A whole failure domain (rack) crashes at once — the correlated
    failure the placement layer must keep inside the n - k budget."""
    victims = layout.nodes_in(rack)
    if len(victims) > layout.n_nodes - k:
        raise ValueError(
            f"rack {rack} holds {len(victims)} nodes > n-k = "
            f"{layout.n_nodes - k}: layout cannot survive its loss")
    ev = read_traffic(layout.n_nodes, t1=horizon, reads=reads, seed=seed)
    ev += [fail(at, v) for v in victims]
    ev += victim_reads(victims, at, burst=2)
    return Scenario("rack_failure", tuple(ev),
                    f"rack {rack} ({victims}) lost at t={at}")


def rolling_restart(n: int, *, start: float = 1.0, dwell: float = 0.5,
                    reads_per_node: int = 6, seed: int = 5) -> Scenario:
    """Nodes restart one at a time (down -> up with data intact); reads of
    the restarting node's block degrade, zero repair traffic is moved."""
    ev: list[Event] = []
    t = start
    for node in range(1, n + 1):
        ev.append(down(t, node))
        ev.append(up(t + dwell, node))
        ev += read_traffic(n, t0=t, t1=t + dwell, reads=reads_per_node,
                           seed=seed + node)
        ev.append(read(t + dwell / 2, node - 1))    # the restarting node's
        t += dwell                                  # block: must degrade
    return Scenario("rolling_restart", tuple(ev),
                    f"sequential restart of all {n} nodes, dwell={dwell}")


def standard_scenarios(n: int, k: int, layout: RackLayout | None = None,
                       ) -> list[Scenario]:
    """The benchmark/test battery: every scenario class the tentpole names."""
    layout = layout or default_layout(n, k)
    return [
        single_node_loss(n),
        multi_node_loss(n, k),
        latent_corruption(n),
        straggler(n),
        rack_failure(layout, k),
        rolling_restart(n),
    ]


def default_layout(n: int, k: int) -> RackLayout:
    """The fewest racks (>= 2) whose max rack size fits the n - k erasure
    budget — the one rack-count formula the battery, the benchmark and
    the serving demo all share."""
    from repro_torch.core.placement import rack_layout
    n_racks = max(2, -(-n // max(1, n - k)))
    return rack_layout(n, n_racks)


__all__ = ["Event", "Scenario", "KINDS", "fail", "down", "up", "corrupt",
           "scrub", "slow", "read", "delete", "read_traffic",
           "single_node_loss",
           "multi_node_loss", "latent_corruption", "straggler",
           "rack_failure", "rolling_restart", "standard_scenarios",
           "default_layout"]
