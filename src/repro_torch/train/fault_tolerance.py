"""Fault-tolerance runtime (the port of ``repro.train.fault_tolerance``):
failure injection, heartbeat/straggler detection, elastic re-meshing — the
control plane around the MSR storage layer.

On real hardware these hook the cluster manager; here the same logic runs
against a simulated clock so every policy is unit-testable.  The decisions
(who repairs, from whom, at what bandwidth) are delegated to the paper's
embedded property: helpers are DETERMINED (prev + next-k ring neighbours),
so the control plane never solves coefficient/helper-selection problems —
the paper's central operational claim (paper §IV).

The training loop and the cluster simulator (DESIGN.md §9) share one
failure timeline: `ClusterScheduleInjector` replays a `repro_torch.cluster`
scenario's fail events as training-step crashes, and the Supervisor can
account its checkpoint-repair traffic into the same `MetricsLog` the
serving scenarios report against.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.baselines import rs_scenario_repair_symbols


# ------------------------------------------------------------ failure model
@dataclasses.dataclass(frozen=True)
class FailureEvent:
    step: int
    node: int                    # 1-indexed storage node / host
    kind: str = "crash"          # crash | straggler


class FailureInjector:
    """Deterministic or Poisson failure schedule over training steps."""

    def __init__(self, n_nodes: int, *, schedule: Sequence[FailureEvent] = (),
                 rate_per_step: float = 0.0, seed: int = 0):
        self.n_nodes = n_nodes
        self._fixed = sorted(schedule, key=lambda e: e.step)
        self._rate = rate_per_step
        self._rng = np.random.default_rng(seed)

    def at(self, step: int) -> list[FailureEvent]:
        out = [e for e in self._fixed if e.step == step]
        if self._rate > 0:
            n = self._rng.poisson(self._rate)
            for _ in range(min(n, self.n_nodes - 1)):
                out.append(FailureEvent(step=step,
                                        node=int(self._rng.integers(1, self.n_nodes + 1))))
        return out


class ClusterScheduleInjector(FailureInjector):
    """A `repro_torch.cluster` scenario viewed as a training-step failure
    schedule (DESIGN.md §9).

    The simulator and the training loop share one failure timeline: every
    ``fail`` event in the scenario becomes a crash of the same node at
    step ``round(t * steps_per_time)``, so the exact cluster dynamics a
    scenario benchmarks are what the Supervisor's checkpoint-repair path
    recovers from.

    Parameters
    ----------
    n_nodes : int
        Storage nodes (the code's n).
    scenario : repro_torch.cluster.events.Scenario
        Event stream; only ``fail`` events are injected (down/up events
        are storage-availability concerns the checkpointer's restore path
        handles internally).
    steps_per_time : float
        Training steps per unit of simulated time.
    """

    def __init__(self, n_nodes: int, scenario, *, steps_per_time: float = 1.0):
        schedule = [FailureEvent(step=int(round(e.t * steps_per_time)),
                                 node=e.node)
                    for e in scenario.events if e.kind == "fail"]
        super().__init__(n_nodes, schedule=schedule)


# ---------------------------------------------------------------- heartbeats
class HeartbeatMonitor:
    """Progress-based straggler detection: a node whose reported step lags
    the median by > `lag_threshold` steps, or whose last heartbeat is older
    than `timeout_s`, is flagged.  Mitigation at the caller: re-dispatch the
    laggard's microbatch to a spare (backup-task / speculative execution).

    Nodes the control plane declared dead (`declare_dead`) stay in the
    ``dead()`` set regardless of clock math until they heartbeat again —
    a beat from a removed node is a *rejoin* (recorded in ``rejoined()``),
    the elastic re-admission path a restarted host takes.

    ``straggler_s`` (optional) adds a wall-clock straggler criterion: a
    node whose last beat is older than ``straggler_s`` (but within
    ``timeout_s``) is flagged even if its reported progress looks fine —
    the hung-but-not-dead shape.  Must be strictly less than
    ``timeout_s``; thresholds are validated at construction so a
    misconfigured monitor fails loudly instead of silently never firing.
    """

    def __init__(self, n_nodes: int, *, timeout_s: float = 60.0,
                 lag_threshold: int = 2,
                 straggler_s: Optional[float] = None):
        if n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        if lag_threshold < 0:
            raise ValueError(f"lag_threshold must be >= 0, "
                             f"got {lag_threshold}")
        if straggler_s is not None and not 0 < straggler_s < timeout_s:
            raise ValueError(
                f"straggler_s must be in (0, timeout_s={timeout_s}), got "
                f"{straggler_s} — a straggler window at or past the death "
                f"timeout can never fire")
        self.n_nodes = n_nodes
        self.timeout_s = timeout_s
        self.lag_threshold = lag_threshold
        self.straggler_s = straggler_s
        self._last_beat = {i: 0.0 for i in range(1, n_nodes + 1)}
        self._progress = {i: 0 for i in range(1, n_nodes + 1)}
        self._removed: set[int] = set()
        self._rejoined: list[int] = []

    def beat(self, node: int, step: int, now: float):
        if node not in self._last_beat:
            raise ValueError(f"unknown node {node} (1..{self.n_nodes})")
        if node in self._removed:           # rejoin: re-admit the host
            self._removed.discard(node)
            self._rejoined.append(node)
        self._last_beat[node] = now
        self._progress[node] = max(self._progress[node], step)

    def declare_dead(self, node: int) -> None:
        """Control-plane removal: the node stays dead until it beats again
        (crash recovery marks the crashed host here; a later beat is the
        rejoin)."""
        if node not in self._last_beat:
            raise ValueError(f"unknown node {node} (1..{self.n_nodes})")
        self._removed.add(node)

    def rejoined(self) -> list[int]:
        """Nodes that heartbeat after being declared dead, in rejoin order."""
        return list(self._rejoined)

    def dead(self, now: float) -> list[int]:
        return sorted(set(self._removed) |
                      {i for i, t in self._last_beat.items()
                       if now - t > self.timeout_s})

    def stragglers(self, now: float) -> list[int]:
        dead = set(self.dead(now))
        alive = [i for i in self._last_beat if i not in dead]
        if not alive:
            return []
        med = float(np.median([self._progress[i] for i in alive]))
        out = {i for i in alive if med - self._progress[i] > self.lag_threshold}
        if self.straggler_s is not None:
            out |= {i for i in alive
                    if now - self._last_beat[i] > self.straggler_s}
        return sorted(out)

    def suspects(self, now: float) -> dict[str, list[int]]:
        """The heartbeat→helper-selection feed (DESIGN.md §13.3): nodes a
        read front end should route around — ``dead`` (declared or past
        ``timeout_s``) and ``stragglers`` (progress lag or the
        wall-clock ``straggler_s`` criterion).  The serving layer
        demotes both to last-resort helpers, so a straggler is avoided
        BEFORE any hedge timer fires rather than merely raced."""
        return {"dead": self.dead(now), "stragglers": self.stragglers(now)}


# ------------------------------------------------------------------ elastic
@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_alive: int
    data_parallel: int           # new data-axis extent
    dropped_nodes: tuple[int, ...]
    microbatch_scale: float      # factor to keep the global batch constant

    @property
    def changed(self) -> bool:
        return bool(self.dropped_nodes)


def plan_elastic(n_nodes: int, dead: Iterable[int], *,
                 keep_global_batch: bool = True) -> ElasticPlan:
    """Shrink the data-parallel extent to the largest power-of-two <= alive
    hosts (mesh axes must stay regular); surviving hosts absorb the dropped
    ranks' share via more grad-accumulation microbatches."""
    dead = tuple(sorted(set(dead)))
    alive = n_nodes - len(dead)
    if alive < 1:
        raise RuntimeError("no hosts left")
    dp = 2 ** int(math.log2(alive))
    scale = (n_nodes / dp) if keep_global_batch else 1.0
    return ElasticPlan(n_alive=alive, data_parallel=dp, dropped_nodes=dead,
                       microbatch_scale=scale)


# --------------------------------------------------------------- supervisor
class Supervisor:
    """Drives train-step execution with failure handling:

    on crash events at step t:
      1. flag the node dead; if a checkpoint exists, REPAIR its shard via the
         MSR newcomer protocol (gamma = (k+1)B/2k reads, not B);
      2. restore the training state (systematic path for survivors);
      3. re-plan the mesh if the node stays gone (elastic), else resume.

    The loop is synchronous-SPMD, so a crash loses at most the steps since
    the last checkpoint; the MSR layer's job is to make the *storage* repair
    cheap and deterministic.

    **Write-behind mode** (``write_behind=True``, DESIGN.md §12.5): save
    points call ``checkpointer.save_async`` — the state is snapshotted on
    device and encoded/written on a background thread while training
    continues ("zero-stall" checkpointing).  At most one save is in
    flight; the supervisor fences (``barrier``) before any crash-recovery
    restore and before returning, so recovery never races a write and the
    returned state is always durably backed.  A background save that
    FAILS surfaces at the barrier: ``on_save_error="raise"`` re-raises
    (strict durability), ``"log"`` records a ``ckpt_failed`` event and
    continues — the previous committed generation still bounds the loss.
    """

    def __init__(self, checkpointer, injector: Optional[FailureInjector] = None,
                 *, ckpt_every: int = 10, metrics=None,
                 write_behind: bool = False, on_save_error: str = "raise"):
        """``metrics``: optional `repro_torch.cluster.MetricsLog` — repair
        traffic from crash recovery is accounted there against the RS
        re-download baseline, alongside any serving-scenario traffic."""
        if on_save_error not in ("raise", "log"):
            raise ValueError(f"on_save_error must be 'raise' or 'log', "
                             f"got {on_save_error!r}")
        if write_behind and not hasattr(checkpointer, "save_async"):
            raise ValueError("write_behind=True needs a checkpointer with "
                             "save_async/barrier (MSRCheckpointer)")
        self.ckpt = checkpointer
        self.injector = injector
        self.ckpt_every = ckpt_every
        self.metrics = metrics
        self.write_behind = write_behind
        self.on_save_error = on_save_error
        self.log: list[dict] = []

    def _barrier(self, step: int) -> None:
        """Fence the in-flight background save (no-op when none).  A save
        failure surfaces HERE — logged, then re-raised unless
        ``on_save_error="log"``."""
        if not hasattr(self.ckpt, "barrier"):
            return
        try:
            self.ckpt.barrier()
        except Exception as e:
            self.log.append({"step": step, "event": "ckpt_failed",
                             "error": repr(e)})
            if self.on_save_error == "raise":
                raise

    def run(self, state, step_fn: Callable, data_fn: Callable, n_steps: int,
            start_step: int = 0):
        """data_fn: step -> batch (stateless indexing — after a rollback the
        exact stream replays, no loss/duplication)."""
        step = start_step
        consumed: set[tuple[int, int]] = set()
        while step < start_step + n_steps:
            events = self.injector.at(step) if self.injector else []
            crashes = [e for e in events if e.kind == "crash"
                       and (e.step, e.node) not in consumed]
            consumed.update((e.step, e.node) for e in crashes)
            if crashes:
                # recovery must see a settled checkpoint directory: fence
                # the in-flight write-behind save BEFORE listing steps()
                self._barrier(step)
            if crashes and self.ckpt.steps():
                last = self.ckpt.steps()[-1]
                failed = [e.node for e in crashes]
                repaired_bytes = 0
                if len(failed) == 1:
                    repaired_bytes = self.ckpt.repair_node(last, failed[0])
                    state, report = self.ckpt.restore(state, last)
                else:
                    state, report = self.ckpt.restore(state, last,
                                                      failed_nodes=failed)
                self.log.append({
                    "step": step, "event": "repair", "failed": failed,
                    "ckpt_step": last, "restore_path": report.path,
                    "repair_bytes": repaired_bytes or report.bytes_read,
                })
                if self.metrics is not None:
                    spec = self.ckpt.spec
                    block_symbols = report.bytes_total_stored // (2 * spec.n)
                    self.metrics.record_repair(
                        len(failed), repaired_bytes or report.bytes_read,
                        rs_scenario_repair_symbols(spec.k, block_symbols,
                                                   len(failed)))
                step = last          # roll back to the checkpoint
                continue
            batch = data_fn(step)
            state, metrics = step_fn(state, batch)
            self.log.append({"step": step, "event": "step",
                             "loss": float(metrics["loss"])})
            step += 1
            if step % self.ckpt_every == 0:
                if self.write_behind:
                    # fence (with policy) BEFORE submitting: save_async's
                    # own internal barrier would re-raise a previous
                    # failure past the on_save_error="log" handling
                    self._barrier(step)
                    self.ckpt.save_async(step, state)
                    self.log.append({"step": step, "event": "ckpt_async"})
                else:
                    self.ckpt.save(step, state)
                    self.log.append({"step": step, "event": "ckpt"})
        # the state handed back must be durably backed: fence the last
        # background save before returning
        self._barrier(step)
        return state


__all__ = ["FailureEvent", "FailureInjector", "ClusterScheduleInjector",
           "HeartbeatMonitor", "ElasticPlan", "plan_elastic", "Supervisor"]
