"""Degraded-read block serving over the cluster simulator (the
`CodedReadServer` half of ``repro.serve.engine``).

Every read goes to the block's assigned node when it is up (systematic:
raw bytes, zero field operations) and *transparently* falls back to a
one-launch any-k decode through the fused repair engine's cached inverses
when assigned nodes are down, slow, or lost.  The node state, latency
model and byte accounting come from `repro_torch.cluster.ClusterSimulator`,
so a serving workload and a failure scenario compose directly.

The reference's ``ServingEngine`` (batched LLM inference fed from coded
storage) needs the model stack, which is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from repro_torch.core import placement
from repro_torch.exec.plan import PlanStats


class CodedReadServer:
    """Degraded-read serving facade over a cluster simulator.

    Parameters
    ----------
    sim : repro_torch.cluster.ClusterSimulator
        Owns node state, the encoded blocks, the latency model and the
        metrics log.  Reads issued here and scenario events run through
        ``sim.run`` share one accounting stream.
    treedef, tspec : optional
        When the stored object is a tree (`placement.pytree_to_blocks`),
        these let :meth:`read_state` rebuild it.

    Notes
    -----
    The degraded path is exactly the paper's any-k data-collector decode,
    but served one *row* at a time: block a_j is ``inv[j] @ downloads``
    with the (n, n) inverse LRU-cached per node subset, so an outage's
    worth of degraded reads costs one `gf.gauss_inverse` total.  Every
    degraded decode goes through the execution-plan layer, so a serving
    fleet reading objects of mixed sizes compiles nothing new at steady
    state — :meth:`plan_stats` is the live counter.
    """

    def __init__(self, sim, treedef=None, tspec=None):
        self.sim = sim
        self.treedef = treedef
        self.tspec = tspec
        self._clock = 0.0

    def plan_stats(self) -> PlanStats:
        """Hits/misses/compiles of the code's execution-plan cache —
        steady-state serving must show a frozen ``compiles`` count."""
        planner = self.sim.code.planner
        if planner is None:
            return PlanStats(0, 0, 0)
        return planner.plan_stats()

    @classmethod
    def for_pytree(cls, state: Any, spec, **sim_kwargs) -> "CodedReadServer":
        """Encode a tree across the cluster and serve reads of it.

        Serializes ``state`` into the code's n data blocks
        (`placement.pytree_to_blocks`), builds a fresh `ClusterSimulator`
        holding the encoded blocks (``device=`` among ``sim_kwargs``; None
        is the card), and returns the server wired for
        :meth:`read_state`.
        """
        from repro_torch.cluster.simulator import ClusterSimulator
        blocks, treedef, tspec = placement.pytree_to_blocks(
            state, spec.n, spec.p)
        sim = ClusterSimulator(spec, blocks, **sim_kwargs)
        return cls(sim, treedef=treedef, tspec=tspec)

    def _tick(self) -> float:
        self._clock += 1.0
        return self._clock

    def read_block(self, block: int) -> Optional[np.ndarray]:
        """One data block, systematic or transparently degraded;
        None only when fewer than k nodes are up."""
        return self.sim.read_block(block, self._tick())

    def read_blocks(self) -> Optional[np.ndarray]:
        """The full (n, S) data matrix — systematic rows where owners are
        up, ONE decode launch for everything else."""
        return self.sim.read_all(self._tick())

    def read_state(self) -> Any:
        """Rebuild the stored tree (requires ``for_pytree``), its leaves
        tensors on the simulator's device, whatever the current node
        state — raises only below k survivors."""
        if self.treedef is None or self.tspec is None:
            raise RuntimeError("server was not built with for_pytree()")
        blocks = self.read_blocks()
        if blocks is None:
            raise RuntimeError(
                f"unrecoverable: fewer than k={self.sim.k} nodes up")
        return placement.blocks_to_pytree(blocks, self.treedef, self.tspec,
                                          self.sim.device)

    @property
    def metrics(self):
        return self.sim.metrics


__all__ = ["CodedReadServer"]
