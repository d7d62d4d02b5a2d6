"""Prioritized background repair scheduler (the port of
``repro.store.scheduler``, DESIGN.md §10.3).

The scheduler sits between a failure feed and the store's repair
primitives:

* **subscribe** — it consumes the same typed ``Event`` stream the
  cluster simulator publishes (``store.subscribe(sched.on_event)`` or
  ``ClusterSimulator.subscribe(sched.on_event)``); every ``fail`` event
  enqueues the stripes that placed a share on the dead node;
* **prioritize** — the queue key is *remaining redundancy*
  ``(n - k) - lost_shares``: a stripe one failure away from data loss
  (remaining 0) drains before stripes that can still absorb losses.
  Priorities are recomputed at pop time, so a stripe that lost another
  share while queued jumps the line and a stripe repaired out of band
  is dropped;
* **coalesce** — all single-loss stripes whose embedded d = k+1 helpers
  are present fold into coalesced ``regenerate_batch`` dispatches (one
  per ``repair_tile_tasks`` window — a single dispatch for typical
  drains; the repair matrix is node-invariant, so stripes that lost
  different code nodes still share one launch, and the window's
  helper gathering / share writes overlap the neighbouring window's
  planned compute through the store pipeline, DESIGN.md §11.3);
  multi-loss stripes fall back to the one-matmul full decode per
  stripe;
* **throttle** — each ``drain`` tick moves at most
  ``budget_symbols_per_tick`` repair symbols, derived from the link
  model's bandwidth and the configurable ``repair_bandwidth_fraction``
  (repair must not starve foreground traffic); ``drain_all`` reports
  how many ticks (and simulated seconds) emptying the queue took.

Byte accounting lands in ``store.metrics`` with the classical-RS
re-download baseline (`CodedObjectStore.rs_baseline_symbols`), so a
scenario's repair-traffic ratio is read off exactly like the cluster
simulator's.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

from repro_torch.cluster.events import Event
from repro_torch.cluster.metrics import LinkModel

from .object_store import CodedObjectStore, ShareIntegrityError


@dataclasses.dataclass
class DrainReport:
    """What one ``drain`` tick (or a full ``drain_all``) accomplished."""
    repaired_stripes: int = 0
    repaired_shares: int = 0
    symbols_moved: int = 0
    rs_baseline_symbols: int = 0
    batch_calls: int = 0          # coalesced regenerate_batch dispatches
    decode_calls: int = 0         # full-decode (multi-loss) dispatches
    unrecoverable: int = 0        # dropped: < k shares left (needs re-put)
    remaining: int = 0            # queue depth after the tick
    ticks: int = 1
    drain_time_s: float = 0.0     # simulated: max(transfer + overheads,
                                  # budget throttle at tick_s per budget)
    converted_objects: int = 0    # online code conversions completed
    convert_symbols: int = 0      # read-side symbols those conversions moved

    @property
    def ratio_vs_rs(self) -> Optional[float]:
        if self.rs_baseline_symbols == 0:
            return None
        return self.symbols_moved / self.rs_baseline_symbols

    def merge(self, other: "DrainReport") -> None:
        self.repaired_stripes += other.repaired_stripes
        self.repaired_shares += other.repaired_shares
        self.symbols_moved += other.symbols_moved
        self.rs_baseline_symbols += other.rs_baseline_symbols
        self.batch_calls += other.batch_calls
        self.decode_calls += other.decode_calls
        self.unrecoverable += other.unrecoverable
        self.remaining = other.remaining
        self.drain_time_s += other.drain_time_s
        self.converted_objects += other.converted_objects
        self.convert_symbols += other.convert_symbols


class RepairScheduler:
    """Background repair queue for a :class:`CodedObjectStore`.

    Parameters
    ----------
    store : CodedObjectStore
        The store whose stripes are repaired.
    link : LinkModel, optional
        Service-time model; defaults to the store's.
    repair_bandwidth_fraction : float
        Fraction of one node's link budgeted for repair per tick.
    tick_s : float
        Simulated tick length; the per-tick symbol budget is
        ``bandwidth_bps * tick_s * fraction`` (symbols ~ bytes over
        GF(257) systematic storage).

    Examples
    --------
    >>> from repro_torch.core.circulant import CodeSpec
    >>> store = CodedObjectStore(CodeSpec.make(2, 257), stripe_symbols=8,
    ...                          device="cpu")
    >>> sched = RepairScheduler(store)
    >>> store.subscribe(sched.on_event)
    >>> _ = store.put("x", bytes(range(64)))
    >>> store.fail_node(1)
    >>> rep = sched.drain_all()
    >>> (sched.pending(), store.get("x") == bytes(range(64)))
    (0, True)
    """

    def __init__(self, store: CodedObjectStore, *,
                 link: Optional[LinkModel] = None,
                 repair_bandwidth_fraction: float = 0.1,
                 tick_s: float = 1.0):
        self.store = store
        self.link = link or store.link
        self.repair_bandwidth_fraction = float(repair_bandwidth_fraction)
        self.tick_s = float(tick_s)
        self._heap: list[tuple[int, int, str, int]] = []
        self._queued: set[tuple[str, int]] = set()
        self._seq = 0
        self._converts: list[tuple[str, object]] = []

    # --------------------------------------------------------------- intake
    def on_event(self, event: Event) -> None:
        """Failure-feed subscriber (store or cluster-simulator events).

        ``fail`` enqueues the dead node's stripes; ``up`` enqueues a
        replaced slot's still-lost stripes — that is how shares lost at
        birth (put while the node was down) get re-protected once a
        newcomer takes the slot; ``delete`` purges the key's queued
        tasks, so deleted objects stop costing pop-time revalidation."""
        if event.kind in ("fail", "up"):
            self.enqueue_node(event.node)
        elif event.kind == "delete":
            self.purge_key(event.key)

    def enqueue_node(self, node: int) -> int:
        """Queue every stripe that placed a share on ``node``; returns how
        many were newly enqueued."""
        added = 0
        for key, t in self.store.stripes_on(node):
            added += self.enqueue_stripe(key, t)
        return added

    def enqueue_scan(self) -> int:
        """Full-store scan: queue every stripe with ANY lost share —
        restart recovery (DESIGN.md §12.5).  A scheduler created after a
        crash has no memory of the failure events that preceded it; one
        scan rebuilds the queue from the store's ground truth (a
        restart-mid-drain drill is ``enqueue_scan()`` + ``drain_all()``).
        Returns how many stripes were newly enqueued."""
        added = 0
        for key, t in list(self.store.stripe_refs()):
            added += self.enqueue_stripe(key, t)
        return added

    def enqueue_stripe(self, key: str, t: int) -> int:
        lost = self.store.lost_code_nodes(key, t)
        if not lost:
            return 0
        if (key, t) in self._queued:
            # already queued at an older (higher) priority: push a second
            # entry at the current loss count — the lower-remaining copy
            # pops first, stale copies are discarded at pop time
            self._push(key, t, len(lost))
            return 0
        self._push(key, t, len(lost))
        return 1

    def _push(self, key: str, t: int, n_lost: int) -> None:
        # priority = remaining redundancy under the OBJECT'S code class
        # (DESIGN.md §15.1); 0 (one failure from loss) first
        n_code, k_code, _d = self._code_params(key)
        remaining = (n_code - k_code) - n_lost
        self._seq += 1
        heapq.heappush(self._heap, (remaining, self._seq, key, t))
        self._queued.add((key, t))

    def _code_params(self, key: str) -> tuple[int, int, int]:
        """(n, k, d) of the key's code class; the store's defaults when
        the key vanished (stale queue entries revalidate at pop time)."""
        try:
            cc = self.store.class_of(key)
        except KeyError:
            return self.store.n, self.store.k, self.store.k + 1
        return cc.n, cc.k, cc.d

    # ------------------------------------------------------- code conversion
    def enqueue_convert(self, key: str, target_class) -> None:
        """Queue an online code conversion (DESIGN.md §15.3); ``drain``
        runs conversions with whatever budget repairs leave — protection
        first, re-encoding second."""
        self._converts.append((key, target_class))

    def pending_converts(self) -> int:
        return len(self._converts)

    def purge_key(self, key: str) -> int:
        """Drop every queued task for ``key`` (the store's ``delete``
        notification): membership leaves ``_queued`` now, and the stale
        heap entries are discarded lazily at pop time like any other
        duplicate.  Returns how many tasks were dropped."""
        dropped = {kt for kt in self._queued if kt[0] == key}
        self._queued -= dropped
        return len(dropped)

    def pending(self) -> int:
        return len(self._queued)

    def peek_order(self) -> list[tuple[str, int, int]]:
        """Queue snapshot as (key, stripe, remaining_redundancy), in drain
        order — for tests and dashboards; does not consume the queue.
        Duplicate entries (priority updates) collapse to the most urgent."""
        seen: set[tuple[str, int]] = set()
        out = []
        for rem, _, key, t in sorted(self._heap):
            if (key, t) in self._queued and (key, t) not in seen:
                seen.add((key, t))
                out.append((key, t, rem))
        return out

    # ---------------------------------------------------------------- drain
    def budget_symbols_per_tick(self) -> int:
        """The throttle: symbols/tick from the link bandwidth budget."""
        return max(1, int(self.link.bandwidth_bps * self.tick_s
                          * self.repair_bandwidth_fraction))

    def drain(self, budget_symbols: Optional[int] = None) -> DrainReport:
        """One throttled tick: pop stripes in priority order until the
        symbol budget is spent, coalesce, dispatch, account.

        Stale queue entries are re-validated at pop time: a stripe whose
        loss count changed is re-queued at its current priority; one
        with nothing lost any more is dropped.
        """
        budget = self.budget_symbols_per_tick() \
            if budget_symbols is None else max(1, int(budget_symbols))
        store = self.store
        s = store.S
        report = DrainReport()
        embedded: list[tuple[str, int, int]] = []   # coalesced single-loss
        full: list[tuple[str, int, tuple[int, ...]]] = []
        selected: set[tuple[str, int]] = set()
        spent = 0
        while self._heap:
            rem, _, key, t = self._heap[0]
            if (key, t) not in self._queued or (key, t) in selected:
                heapq.heappop(self._heap)           # stale dup entry
                continue
            try:
                lost = store.lost_code_nodes(key, t)
            except KeyError:                        # object deleted
                heapq.heappop(self._heap)
                self._queued.discard((key, t))
                continue
            if not lost:
                heapq.heappop(self._heap)
                self._queued.discard((key, t))
                continue
            n_code, k_code, d_code = self._code_params(key)
            if len(lost) > n_code - k_code:         # data loss: fewer than
                heapq.heappop(self._heap)           # k shares left — only a
                self._queued.discard((key, t))      # re-put can help, so it
                report.unrecoverable += 1           # must not wedge the queue
                continue
            now_rem = (n_code - k_code) - len(lost)
            if now_rem != rem:                      # priority drifted
                heapq.heappop(self._heap)
                self._push(key, t, len(lost))       # requeue at current prio
                continue
            # bandwidth-optimal regeneration (d * S, eq. (7)) when the
            # object's family has a plan from the present shares; full
            # decode (B = k * q * S) otherwise — per-key code geometry
            regen_ok = (len(lost) == 1
                        and store.embedded_helpers_present(key, t, lost[0]))
            cost = d_code * s if regen_ok \
                else k_code * (d_code - k_code + 1) * s
            if spent + cost > budget and spent > 0:
                break                               # budget exhausted
            heapq.heappop(self._heap)
            selected.add((key, t))
            spent += cost
            if regen_ok:
                embedded.append((key, t, lost[0]))
            else:
                full.append((key, t, lost))
        # provision newcomers for every slot we are about to write — their
        # `up` events may enqueue OTHER still-lost stripes on the slot
        # (lost-at-birth re-protection); the selected set stays in
        # _queued until its repairs land so those events cannot double-
        # enqueue the work in flight.  The finally block keeps queue state
        # and byte accounting consistent with whatever repairs actually
        # landed, even if one raises mid-tick.
        completed: set[tuple[str, int]] = set()
        try:
            self._replace_target_nodes(embedded, full)
            if embedded:
                # a rotten helper (persistent CRC failure) must not be
                # decoded FROM: skip the batch, requeue via the finally
                # block, and let a scrub drop the bad share first
                try:
                    moved, dispatches = \
                        store.repair_stripes_embedded(embedded)
                except ShareIntegrityError:
                    pass
                else:
                    report.symbols_moved += moved
                    report.batch_calls += dispatches
                    report.repaired_stripes += len(embedded)
                    report.repaired_shares += len(embedded)
                    # per-key RS baseline: each task rebuilt one share of
                    # ITS object's code class (identical to the legacy
                    # store-wide formula when everything is default-class)
                    report.rs_baseline_symbols += sum(
                        store.rs_baseline_symbols_for(key, 1)
                        for key, _t, _n in embedded)
                    completed.update((key, t) for key, t, _ in embedded)
            for key, t, lost in full:
                try:
                    report.symbols_moved += \
                        store.repair_stripe_full(key, t, lost)
                except ShareIntegrityError:
                    continue
                report.decode_calls += 1
                report.repaired_stripes += 1
                report.repaired_shares += len(lost)
                report.rs_baseline_symbols += \
                    store.rs_baseline_symbols_for(key, len(lost))
                completed.add((key, t))
        finally:
            for kt in selected:
                self._queued.discard(kt)
            for key, t in selected - completed:     # repair raised: requeue
                self.enqueue_stripe(key, t)         # at the current priority
            if report.repaired_shares:
                store.metrics.record_repair(report.repaired_shares,
                                            report.symbols_moved,
                                            report.rs_baseline_symbols)
        # online conversions run on whatever budget repairs left this
        # tick (protection first, re-encoding second); each conversion's
        # read-side traffic is charged against the same symbol budget
        while self._converts and spent < budget:
            key, target = self._converts.pop(0)
            try:
                receipt = store.convert(key, target)
            except KeyError:
                continue                            # deleted while queued
            report.converted_objects += 1
            report.convert_symbols += receipt.bytes_read
            spent += max(1, receipt.bytes_read)
        report.remaining = self.pending()
        n_tasks = len(embedded) + len(full)
        # simulated tick duration: the raw transfer + per-task overheads,
        # floored by the THROTTLE — the budget grants at most `budget`
        # symbols per tick_s of simulated time, so a tick that spends its
        # whole budget costs tick_s however fast the link could move it
        # (this is what makes drain_time_s a function of the budget)
        moved = report.symbols_moved + report.convert_symbols
        raw_s = (moved / self.link.bandwidth_bps
                 + n_tasks * self.link.request_overhead_s
                 + report.decode_calls * self.link.decode_overhead_s)
        throttle_s = moved / budget * self.tick_s
        report.drain_time_s = max(raw_s, throttle_s)
        return report

    def _replace_target_nodes(self, embedded, full) -> None:
        targets: set[int] = set()
        for key, t, node in embedded:
            targets.add(self.store.placement_of(key, t)[node - 1])
        for key, t, lost in full:
            pl = self.store.placement_of(key, t)
            targets.update(pl[i - 1] for i in lost)
        for phys in targets:
            if not self.store.is_up(phys):
                self.store.replace_node(phys)

    def drain_all(self, budget_symbols: Optional[int] = None,
                  max_ticks: int = 100_000) -> DrainReport:
        """Tick until the queue is empty; the merged report's ``ticks``
        and ``drain_time_s`` are the queue-drain-time-vs-budget numbers
        ``BENCH_store.json`` tracks."""
        total = DrainReport(ticks=0)
        while self.pending() or self._converts:
            if total.ticks >= max_ticks:
                raise RuntimeError(f"repair queue not drained after "
                                   f"{max_ticks} ticks")
            rep = self.drain(budget_symbols)
            total.merge(rep)
            total.ticks += 1
            if rep.repaired_stripes == 0 and rep.converted_objects == 0 \
                    and (rep.remaining or self._converts):
                raise RuntimeError(
                    "repair stalled: pending stripes cannot be repaired "
                    "(fewer than k shares present?)")
        return total


__all__ = ["RepairScheduler", "DrainReport"]
