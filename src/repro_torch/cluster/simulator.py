"""Event-driven cluster failure simulator (the port of
``repro.cluster.simulator``).

Drives the fused repair engine through realistic cluster dynamics: the
simulator owns the *actual* encoded blocks of every node — int32 tensors
on the simulator's device, so repair and degraded reads are real field
computations on the card, verifiable bit-exactly against the original
encode — a node-state machine (UP / DOWN / FAILED), a deterministic
latency model, and the repair policy:

* single failure with its embedded helpers up -> the fused (2, k+1)
  repair-matrix regeneration, gamma = (k+1) * S symbols moved;
* anything else (multi-failure, rack loss, helpers down) -> the one-matmul
  multi-failure decode (`reconstruct_with_repair`): 2k * S symbols moved
  TOTAL regardless of how many nodes come back;
* silent corruption -> latent until a ``scrub`` event re-derives every
  pair through the batched engine and repairs the flagged set.

Client reads are part of the event stream: a read of block a_j is served
systematically from its owner when that is the fastest available path,
and otherwise *transparently degrades* to a one-row cached-inverse decode
from the k fastest up nodes, whose data and redundancy downloads are the
decode's two row sources.  Reads return numpy arrays, as the reference's
do; the serving layer (`repro_torch.serve.engine`) builds on
:meth:`ClusterSimulator.read_block`.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.circulant import CodeSpec
from repro_torch.core.msr import DoubleCirculantMSR
from repro_torch.core.placement import RackLayout
from repro_torch.device import as_int32, device_of

from .events import Event, Scenario
from .metrics import LinkModel, MetricsLog

UP, DOWN, FAILED = "up", "down", "failed"


@dataclasses.dataclass
class ScenarioReport:
    """Outcome of one scenario run.

    ``bit_exact`` is the simulator's ground-truth check: after the run,
    every node is UP and its stored (a, r) pair equals the original
    encode symbol-for-symbol.
    """
    name: str
    description: str
    metrics: dict
    bit_exact: bool
    final_states: tuple[str, ...]
    unserved_events: int = 0

    def to_json(self) -> dict:
        return {
            "scenario": self.name,
            "description": self.description,
            "bit_exact": self.bit_exact,
            "final_states": list(self.final_states),
            **self.metrics,
        }


class ClusterSimulator:
    """A [n = 2k, k] MSR storage cluster under an event stream.

    Parameters
    ----------
    spec : CodeSpec
        The validated double circulant code.
    data : ndarray or tensor, shape (n, S)
        Original data blocks; the simulator encodes redundancy itself so
        node contents are bit-exact ground truth.
    code : DoubleCirculantMSR, optional
        Share an existing code instance (and its decode-inverse cache);
        its device is the simulator's.
    layout : RackLayout, optional
        Failure-domain map (for reporting; rack scenarios come from
        `events.rack_failure`).
    link : LinkModel, optional
        Latency model for simulated read/repair timing.
    repair_delay : float
        Simulated seconds between a failure and its repair completing;
        reads in that window run degraded.
    straggler_mitigation : bool
        When True, a read whose owner is slow is served degraded if the
        k-helper path is faster.
    device : torch.device or str, optional
        Where the node blocks live and every field operation runs; None
        is the CUDA card (raises without one).  Ignored when ``code`` is
        given.

    Attributes
    ----------
    node_a, node_r : torch.Tensor
        (n, S) int32 blocks each node holds (row i is node v_{i+1}).
    """

    def __init__(self, spec: CodeSpec, data, *,
                 code: Optional[DoubleCirculantMSR] = None,
                 layout: Optional[RackLayout] = None,
                 link: Optional[LinkModel] = None,
                 repair_delay: float = 0.25,
                 straggler_mitigation: bool = True,
                 device=None):
        self.spec = spec
        self.k, self.n, self.p = spec.k, spec.n, spec.p
        self.code = code or DoubleCirculantMSR(
            spec, device=device_of(data, device=device))
        self.device = self.code.device
        data = torch.remainder(as_int32(data, spec.p, self.device), spec.p)
        if data.shape[0] != self.n:
            raise ValueError(f"expected {self.n} data blocks, "
                             f"got {data.shape[0]}")
        self.layout = layout
        self.link = link or LinkModel()
        self.repair_delay = repair_delay
        self.straggler_mitigation = straggler_mitigation

        self._orig_a = data
        self._orig_r = self.code.encode(data)
        self.node_a = self._orig_a.clone()
        self.node_r = self._orig_r.clone()
        self.S = data.shape[1]
        self.state = [UP] * self.n            # index 0 = node v_1
        self.slow = [1.0] * self.n
        self.metrics = MetricsLog()
        self.log: list[dict] = []
        self._subscribers: list = []

    # --------------------------------------------------------------- events
    def subscribe(self, fn) -> None:
        """Register ``fn(event)`` to receive every Event the simulator
        processes (scenario events AND interactively-injected failures) —
        the feed a store's `RepairScheduler.on_event` can share."""
        self._subscribers.append(fn)

    def _notify(self, event: Event) -> None:
        for fn in self._subscribers:
            fn(event)

    # ------------------------------------------------------------- node view
    def _check_node(self, node: int) -> int:
        if not 1 <= node <= self.n:
            raise ValueError(f"node {node} out of range 1..{self.n} "
                             f"(nodes are 1-indexed)")
        return node

    def is_up(self, node: int) -> bool:
        return self.state[node - 1] == UP

    def up_nodes(self) -> list[int]:
        return [i + 1 for i in range(self.n) if self.state[i] == UP]

    def _fastest_helpers(self, ups: list[int]) -> list[int]:
        """The k up nodes with the smallest service time, id-sorted so the
        subset is canonical for the decode-inverse cache."""
        return sorted(
            sorted(ups, key=lambda i: (self.slow[i - 1], i))[: self.k])

    def _downloads(self, helpers: list[int]):
        """The decode's row sources: the helpers' data and redundancy
        blocks, gathered on the device (no concatenated download)."""
        idx = torch.as_tensor([h - 1 for h in helpers], device=self.device)
        return self.node_a[idx], self.node_r[idx]

    # ---------------------------------------------------------------- reads
    def read_block(self, block: int, t: float = 0.0) -> Optional[np.ndarray]:
        """Serve data block ``a_block`` (0-based), degrading transparently.

        Returns the (S,) block as numpy, or None when fewer than k nodes
        are up (the only unservable case).  Path choice and latency are
        recorded in :attr:`metrics` (non-systematic serves also land in
        :attr:`log` with their time ``t``); silent corruption is served
        as stored (that is what makes it *latent* — only ``scrub``
        events catch it).
        """
        owner = block + 1
        ups = self.up_nodes()
        sys_ok = self.is_up(owner)
        sys_lat = self.link.fetch_s(self.S, self.slow[owner - 1]) \
            if sys_ok else None

        deg_lat = helpers = None
        if len(ups) >= self.k:
            helpers = self._fastest_helpers(ups)
            deg_lat = self.link.degraded_read_s(
                2 * self.S, [self.slow[h - 1] for h in helpers])

        use_degraded = (
            not sys_ok
            or (self.straggler_mitigation and deg_lat is not None
                and deg_lat < sys_lat))
        if not use_degraded and sys_ok:
            out = self.node_a[block]
            self.metrics.record_read(
                "systematic", sys_lat, self.S,
                corrupt=not torch.equal(out, self._orig_a[block]))
            return out.cpu().numpy()
        if helpers is None:
            self.metrics.record_read("failed", 0.0, 0)
            self.log.append({"t": t, "event": "read_failed", "block": block})
            return None
        out = self._degraded_decode(block, helpers)
        self.metrics.record_read(
            "degraded", deg_lat, 2 * self.k * self.S,
            corrupt=not np.array_equal(
                out, self._orig_a[block].cpu().numpy()))
        self.log.append({"t": t, "event": "degraded_read", "block": block,
                         "helpers": helpers})
        return out

    def read_all(self, t: float = 0.0) -> Optional[np.ndarray]:
        """Serve the full (n, S) data matrix as numpy — the serving
        layer's bulk read (e.g. re-materializing a model's parameters).

        Blocks whose owner is up are served systematically (raw bytes,
        zero field ops); all missing blocks come out of ONE cached-inverse
        decode launch.  Returns None when fewer than k nodes are up.
        """
        ups = self.up_nodes()
        missing = [j for j in range(self.n) if not self.is_up(j + 1)]
        if missing and len(ups) < self.k:
            # the bulk read delivers nothing: no block is billed as served
            for b in range(self.n):
                self.metrics.record_read("failed", 0.0, 0)
                self.log.append({"t": t, "event": "read_failed", "block": b})
            return None
        out = np.empty((self.n, self.S), np.int32)
        for j in range(self.n):
            if j not in missing:
                out[j] = self.node_a[j].cpu().numpy()
                self.metrics.record_read(
                    "systematic", self.link.fetch_s(self.S, self.slow[j]),
                    self.S,
                    corrupt=not torch.equal(self.node_a[j],
                                            self._orig_a[j]))
        if not missing:
            return out
        helpers = self._fastest_helpers(ups)
        mat = self.code.repair.decode_matrix(tuple(helpers))
        # planned dispatch: degraded serving stays on cached plans however
        # many distinct stream extents it sees
        decoded = self.code.repair.apply_planned(
            mat[missing], self._downloads(helpers)).host()
        orig = self._orig_a[torch.as_tensor(missing, device=self.device)]
        orig = orig.cpu().numpy()
        lat = self.link.degraded_read_s(
            2 * self.S, [self.slow[h - 1] for h in helpers])
        for row, j in enumerate(missing):
            out[j] = decoded[row]
            # one download set serves every missing block: bill it once
            self.metrics.record_read(
                "degraded", lat, 2 * self.k * self.S if row == 0 else 0,
                corrupt=not np.array_equal(out[j], orig[row]))
        self.log.append({"t": t, "event": "degraded_read", "block": missing,
                         "helpers": helpers})
        return out

    def fail_node(self, node: int, t: float = 0.0) -> None:
        """Interactive failure injection (the serving demo's kill switch):
        marks the node FAILED and wipes its pair, but does NOT schedule
        the automatic repair — call :meth:`repair_now` when the newcomer
        is provisioned."""
        self._check_node(node)
        self.state[node - 1] = FAILED
        self.node_a[node - 1] = 0
        self.node_r[node - 1] = 0
        self.log.append({"t": t, "event": "fail", "node": node})
        self._notify(Event(t=t, kind="fail", node=node))

    def repair_now(self, t: float = 0.0) -> bool:
        """Repair every FAILED node immediately (see :meth:`_repair_failed`);
        False when fewer than k nodes are up."""
        return self._repair_failed(t)

    def _degraded_decode(self, block: int, helpers: list[int]) -> np.ndarray:
        """One-row cached-inverse decode: a_block = inv[block] @ downloads.

        The (n, n) inverse for the helper subset comes from the engine's
        LRU (`DecodeInverseCache`), so an outage's worth of degraded reads
        costs ONE `gf.gauss_inverse` — each read is a single (1, 2k)
        ``gf_matmul`` launch over the (data, redundancy) row sources."""
        mat = self.code.repair.decode_matrix(tuple(helpers))
        return self.code.repair.apply_planned(
            mat[block:block + 1], self._downloads(helpers)).host()[0]

    # --------------------------------------------------------------- repair
    def _repair_failed(self, t: float) -> bool:
        """Repair every currently-FAILED node; True if any work was done."""
        failed = [i + 1 for i in range(self.n) if self.state[i] == FAILED]
        if not failed:
            return True
        ups = self.up_nodes()
        if len(ups) < self.k:
            return False                        # postpone: not enough alive
        rs_base = baselines.rs_scenario_repair_symbols(
            self.k, self.S, len(failed))
        if len(failed) == 1 and self._embedded_helpers_up(failed[0]):
            f = failed[0]
            plan = self.code.repair_plan(f)
            idx = torch.as_tensor(list(plan.data_indices), device=self.device)
            pair = self.code.repair.regenerate_planned(
                f, self.node_r[plan.prev_node - 1], self.node_a[idx]).device()
            self.node_a[f - 1], self.node_r[f - 1] = pair[0], pair[1]
            moved = (self.k + 1) * self.S       # gamma, eq. (7)
            path = "regenerate"
        else:
            use = sorted(ups)[: self.k]
            data_blocks, red_blocks = self._downloads(use)
            data, red_f = self.code.repair.reconstruct_with_repair(
                use, data_blocks, red_blocks, failed)
            for j, f in enumerate(failed):
                self.node_a[f - 1] = data[f - 1]
                self.node_r[f - 1] = red_f[j]
            moved = 2 * self.k * self.S         # one decode download set
            path = "reconstruct"
        for f in failed:
            self.state[f - 1] = UP
        self.metrics.record_repair(len(failed), moved, rs_base)
        self.log.append({"t": t, "event": "repair", "path": path,
                         "nodes": failed, "symbols_moved": moved})
        return True

    def _embedded_helpers_up(self, node: int) -> bool:
        plan = self.code.repair_plan(node)
        return (self.is_up(plan.prev_node)
                and all(self.is_up(j) for j in plan.next_nodes))

    # ---------------------------------------------------------------- scrub
    def run_scrub(self, t: float = 0.0) -> tuple[int, ...]:
        """Degraded-read verification pass over the whole cluster.

        Stage 1 (localize): re-derive every node pair from its d = k+1
        helpers through the batched fused engine (one launch for all n
        nodes) and compare bit-exactly.  A corrupt block flags its own
        node AND every neighbour whose regeneration consumed it — the
        flagged set localizes, it does not convict.

        Stage 2 (convict + repair): decode the full file from a k-subset,
        re-encode, and rewrite every node whose stored pair disagrees.  If
        enough unflagged nodes exist they form the decode subset directly;
        otherwise the n cyclic k-windows are searched for the decode whose
        re-encode disagrees with the fewest nodes (a clean window's
        disagreement set is exactly the corrupt set).

        Requires all nodes up (a real scrubber skips unavailable ones);
        returns the stage-1 flagged set.
        """
        if any(s != UP for s in self.state):
            self.metrics.record_scrub_skipped()
            self.log.append({"t": t, "event": "scrub", "skipped": True})
            return ()
        nodes = list(range(1, self.n + 1))
        prev = torch.as_tensor([self.code.repair_plan(i).prev_node - 1
                                for i in nodes], device=self.device)
        helper_idx = torch.as_tensor([self.code.repair_plan(i).data_indices
                                      for i in nodes], device=self.device)
        derived = self.code.repair.regenerate_batch_planned(
            nodes, self.node_r[prev], self.node_a[helper_idx]).device()
        bad = ((derived[:, 0] != self.node_a).any(dim=1)
               | (derived[:, 1] != self.node_r).any(dim=1))
        flagged = tuple(int(i) + 1 for i in torch.nonzero(bad).flatten())
        self.metrics.record_scrub(2 * self.n * self.S, len(flagged))
        self.log.append({"t": t, "event": "scrub", "flagged": list(flagged)})
        if flagged:
            corrupt = self._convict(flagged)
            self.log.append({"t": t, "event": "scrub_repair",
                             "nodes": list(corrupt)})
        return flagged

    def _candidate_subsets(self, flagged: tuple[int, ...]):
        clean = [i for i in range(1, self.n + 1) if i not in flagged]
        if len(clean) >= self.k:
            yield tuple(sorted(clean)[: self.k])
            return
        for s0 in range(self.n):                # cyclic k-windows
            yield tuple(sorted((s0 + j) % self.n + 1 for j in range(self.k)))

    def _convict(self, flagged: tuple[int, ...]) -> tuple[int, ...]:
        """Stage-2 scrub resolution: best-consistency decode + rewrite."""
        best = None
        for subset in self._candidate_subsets(flagged):
            data = self.code.repair.apply(
                self.code.repair.decode_matrix(subset),
                self._downloads(list(subset)))
            red = self.code.encode(data)
            disagree = tuple(
                int(i) + 1 for i in torch.nonzero(
                    (data != self.node_a).any(dim=1)
                    | (red != self.node_r).any(dim=1)).flatten())
            if best is None or len(disagree) < len(best[0]):
                best = (disagree, data, red)
            if not disagree:
                break                 # decode agrees with every node: done
        disagree, data, red = best
        if disagree:
            self.node_a[:] = data
            self.node_r[:] = red
            self.metrics.record_repair(
                len(disagree), 2 * self.k * self.S,
                baselines.rs_scenario_repair_symbols(
                    self.k, self.S, len(disagree)))
        return disagree

    # ------------------------------------------------------------ event loop
    def run(self, scenario: Scenario) -> ScenarioReport:
        """Process the scenario's events in time order and report.

        Failures schedule an internal repair completion ``repair_delay``
        later; reads between failure and repair run degraded.  A repair
        blocked by too few up nodes retries after another delay.
        """
        heap: list[tuple[float, int, Optional[Event]]] = []
        seq = 0
        for e in scenario.events:
            heap.append((e.t, seq, e))
            seq += 1
        heapq.heapify(heap)
        retries = 0                 # CONSECUTIVE postponements; resets on
        while heap:                 # success so long scenarios can't starve
            t, _, e = heapq.heappop(heap)
            if e is None:                       # internal: repair completion
                if self._repair_failed(t):
                    retries = 0
                else:
                    retries += 1
                    if retries > 100:
                        raise RuntimeError(
                            "repair starved: fewer than k nodes up for "
                            f"{retries} consecutive attempts")
                    seq += 1
                    heapq.heappush(heap, (t + self.repair_delay, seq, None))
                continue
            if e.kind in ("fail", "down", "up", "corrupt", "slow"):
                self._check_node(e.node)
            if e.kind == "fail":
                self.state[e.node - 1] = FAILED
                self.node_a[e.node - 1] = 0     # contents are gone
                self.node_r[e.node - 1] = 0
                self.log.append({"t": t, "event": "fail", "node": e.node})
                seq += 1
                heapq.heappush(heap, (t + self.repair_delay, seq, None))
            elif e.kind == "down":
                if self.state[e.node - 1] == UP:
                    self.state[e.node - 1] = DOWN
                self.log.append({"t": t, "event": "down", "node": e.node})
            elif e.kind == "up":
                if self.state[e.node - 1] == DOWN:
                    self.state[e.node - 1] = UP
                self.log.append({"t": t, "event": "up", "node": e.node})
            elif e.kind == "corrupt":
                tgt = self.node_a if e.where == "a" else self.node_r
                pos = torch.as_tensor(list(e.positions) or [0],
                                      device=self.device)
                tgt[e.node - 1, pos] = (tgt[e.node - 1, pos] + 1) % self.p
                self.log.append({"t": t, "event": "corrupt", "node": e.node,
                                 "where": e.where})
            elif e.kind == "scrub":
                self.run_scrub(t)
            elif e.kind == "slow":
                self.slow[e.node - 1] = e.factor
            elif e.kind == "read":
                self.read_block(e.block % self.n, t)
            # notify AFTER the event is applied, so subscribers observe
            # the same post-event state whichever injection path (run
            # loop or fail_node) delivered the failure
            self._notify(e)
        return self.report(scenario)

    def report(self, scenario: Scenario) -> ScenarioReport:
        ok = (all(s == UP for s in self.state)
              and torch.equal(self.node_a, self._orig_a)
              and torch.equal(self.node_r, self._orig_r))
        return ScenarioReport(name=scenario.name,
                              description=scenario.description,
                              metrics=self.metrics.summary(),
                              bit_exact=bool(ok),
                              final_states=tuple(self.state),
                              unserved_events=self.metrics.reads_failed)


def run_scenario(spec: CodeSpec, data, scenario: Scenario,
                 **sim_kwargs) -> ScenarioReport:
    """One-shot convenience: fresh simulator, run, report."""
    return ClusterSimulator(spec, data, **sim_kwargs).run(scenario)


__all__ = ["ClusterSimulator", "ScenarioReport", "run_scenario",
           "UP", "DOWN", "FAILED"]
