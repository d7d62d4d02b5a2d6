"""Robust serving front end over the coded object store (the port of
``repro.serve.frontend``).

:class:`ReadFrontEnd` sits in front of :class:`CodedObjectStore` and
makes the read path survive what the drill harness throws at it, by
treating the code's redundancy as a *serving* resource — tail-latency
insurance and integrity armor, not just durability:

* **deadlines + hedged reads** (§13.1) — every request carries a
  deadline budget that propagates into each share fetch (capping the
  retry policy's wall clock via ``budget_s``).  A fetch that exceeds
  the hedge threshold is abandoned: the stripe decodes around the
  laggard through the one-matmul degraded path instead of waiting.
  Per-node EWMA fetch latencies plus :class:`HeartbeatMonitor`
  straggler signals demote known-slow nodes to last-resort helpers
  BEFORE any hedge timer fires.
* **end-to-end read integrity** (§13.2) — every fetched share is
  CRC-verified against the put-time ledger (:func:`share_crc`, the
  logical-CRC convention).  A mismatch is treated as an erasure: the
  stripe decodes around it, the node's suspicion rises, and — when the
  STORED copy is also bad (storage rot, not a transient read-path
  flip) — the share is dropped and the stripe enqueued with the
  repair scheduler.  A corrupt payload never reaches a caller.
* **quarantine** (§13.3) — a suspicion ledger (CRC failures weigh
  most, retry give-ups next, hedged-past fetches least) evicts nodes
  from helper selection at ``quarantine_threshold``; re-admission
  requires a clean targeted scrub (:meth:`CodedObjectStore.scrub_node`)
  — a dirty scrub drops the rotten shares, queues their repairs, and
  keeps the node out until a later scrub comes back clean.
* **admission control + load shedding** (§13.4) — a bounded priority
  queue; concurrent gets coalesce per key, and degraded stripes
  coalesce ACROSS requests by failure pattern into one planned decode
  launch each (one ``gf_matmul`` on the card).  When the queue is full the
  lowest-priority request in sight is shed with a typed
  :class:`Overloaded` — never a hang, never a silent drop.  Background
  repair drains share the same :class:`LinkModel` budget via
  :meth:`tick`.

The front end is single-dispatcher: one thread calls ``submit``/
``pump``/``tick``; only share fetches fan out to the internal pool.
"""
from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.exec.staging import staged, tallied
from repro_torch.io.retry import GiveUpError
from repro_torch.store.object_store import (CodedObjectStore, ObjectStat,
                                            share_crc)

_MIN_PATIENCE_S = 1e-3      # never poll a future with a zero timeout
_CRC_REREADS = 2            # re-fetches after a transient CRC mismatch


class Overloaded(RuntimeError):
    """Typed load-shed error (DESIGN.md §13.4): the admission queue was
    full and this request was the lowest-priority one in sight.  The
    shed ticket resolves immediately with this error — callers always
    get an answer, never a hang or a silent drop."""

    def __init__(self, key: str, priority: int, queue_depth: int):
        super().__init__(f"overloaded: shed read of {key!r} (priority "
                         f"{priority}) at queue depth {queue_depth}")
        self.key = key
        self.priority = priority
        self.queue_depth = queue_depth


@dataclasses.dataclass
class ReadReceipt:
    """What serving one request cost (attached to its ticket)."""
    key: str
    wall_latency_s: float = 0.0
    deadline_s: float = 0.0
    deadline_met: bool = True
    degraded_stripes: int = 0
    hedged_fetches: int = 0
    crc_rejected: int = 0
    coalesced: int = 1            # tickets served by this key's one read
    decode_dispatches: int = 0    # failure patterns this key's read joined
    avoided_nodes: tuple = ()


@dataclasses.dataclass
class ReadTicket:
    """One admitted (or shed) request.  ``result()`` returns the object
    or raises the typed error; it never blocks — ``pump()`` resolves
    tickets synchronously."""
    uid: int
    key: str
    priority: int
    deadline_s: float
    submitted_t: float
    done: bool = False
    obj: Any = None
    error: Optional[BaseException] = None
    receipt: Optional[ReadReceipt] = None

    def result(self) -> Any:
        if not self.done:
            raise RuntimeError(f"request {self.uid} ({self.key!r}) not "
                               f"served yet — pump() the front end")
        if self.error is not None:
            raise self.error
        return self.obj


@dataclasses.dataclass
class NodeHealth:
    """Per-physical-node suspicion ledger + learned fetch latency."""
    suspicion: float = 0.0
    quarantined: bool = False
    crc_failures: int = 0
    timeouts: int = 0             # fetches hedged past
    giveups: int = 0
    scrubs: int = 0
    readmissions: int = 0
    ewma_read_s: Optional[float] = None

    def observe(self, dt: float, alpha: float = 0.3) -> None:
        self.ewma_read_s = dt if self.ewma_read_s is None \
            else (1.0 - alpha) * self.ewma_read_s + alpha * dt


def _percentile(sorted_vals: list, p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     math.ceil(p / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[idx]


class FrontEndMetrics:
    """Front-end accounting: request outcomes, wall-latency tail, and
    every robustness mechanism's fire count."""

    def __init__(self):
        self.requests = 0
        self.served = 0
        self.failed = 0
        self.shed = 0
        self.coalesced_requests = 0   # tickets beyond the first per key
        self.deadline_misses = 0
        self.hedged_fetches = 0
        self.crc_rejected = 0
        self.quarantines = 0
        self.readmissions = 0
        self.decode_dispatches = 0
        self.degraded_stripes = 0
        # stripes of the keys served (degraded or not); not in summary(),
        # which stays the reference's
        self.stripes_read = 0
        self.wall_latencies: list[float] = []

    def latency_percentiles(self) -> dict:
        lat = sorted(self.wall_latencies)
        return {"p50_s": _percentile(lat, 50.0),
                "p99_s": _percentile(lat, 99.0),
                "p999_s": _percentile(lat, 99.9),
                "max_s": lat[-1] if lat else 0.0}

    def summary(self) -> dict:
        return {"requests": self.requests, "served": self.served,
                "failed": self.failed, "shed": self.shed,
                "coalesced_requests": self.coalesced_requests,
                "deadline_misses": self.deadline_misses,
                "hedged_fetches": self.hedged_fetches,
                "crc_rejected": self.crc_rejected,
                "quarantines": self.quarantines,
                "readmissions": self.readmissions,
                "decode_dispatches": self.decode_dispatches,
                "degraded_stripes": self.degraded_stripes,
                "latency": {k: round(v, 6) for k, v in
                            self.latency_percentiles().items()}}


class ReadFrontEnd:
    """Deadline-aware, hedged, integrity-checking read front end.

    Parameters
    ----------
    store : CodedObjectStore
        The store being served.  Its fault injector (if any) drives the
        hedging/quarantine machinery deterministically in tests.
    scheduler : RepairScheduler, optional
        Where CRC-dropped shares get their stripes re-protected, and
        whose drains :meth:`tick` interleaves with foreground serving
        under the shared link budget.
    heartbeat : HeartbeatMonitor, optional
        Its :meth:`suspects` feed (dead + wall-clock/progress
        stragglers) demotes nodes in helper selection before any hedge
        fires.  ``heartbeat_clock`` supplies the monitor's time domain
        (often simulated); defaults to the front end's clock.
    default_deadline_s : float
        Deadline for requests that don't carry one.
    hedge_after_s : float or None
        Per-fetch patience before abandoning a share and decoding
        around it.  ``None`` disables hedging AND latency-based
        avoidance (the unhedged baseline the benchmark A/Bs against).
    max_queue : int
        Admission bound; beyond it the lowest-priority request is shed.
    quarantine_threshold : float
        Suspicion level at which a node is evicted from helper
        selection until a clean scrub re-admits it.
    crc_weight, giveup_weight, hedge_weight : float
        Suspicion increments per signal — integrity failures weigh
        most, being slow weighs least.
    fetch_workers : int
        Pool width for hedged share fetches.
    clock : callable
        Injectable wall clock (tests pin it).
    """

    def __init__(self, store: CodedObjectStore, *,
                 scheduler=None, heartbeat=None,
                 heartbeat_clock: Optional[Callable[[], float]] = None,
                 default_deadline_s: float = 0.25,
                 hedge_after_s: Optional[float] = 0.02,
                 max_queue: int = 64,
                 quarantine_threshold: float = 3.0,
                 crc_weight: float = 2.0,
                 giveup_weight: float = 1.0,
                 hedge_weight: float = 0.5,
                 fetch_workers: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.store = store
        self.scheduler = scheduler
        self.heartbeat = heartbeat
        self.clock = clock
        self.heartbeat_clock = heartbeat_clock or clock
        self.default_deadline_s = float(default_deadline_s)
        self.hedge_after_s = hedge_after_s
        self.max_queue = int(max_queue)
        self.quarantine_threshold = float(quarantine_threshold)
        self.crc_weight = float(crc_weight)
        self.giveup_weight = float(giveup_weight)
        self.hedge_weight = float(hedge_weight)
        self.fetch_workers = int(fetch_workers)
        self.metrics = FrontEndMetrics()
        self.events: list[dict] = []      # quarantine state transitions
        self._health: dict[int, NodeHealth] = {}
        self._queue: list[ReadTicket] = []
        self._uid = 0
        self._pool_obj: Optional[ThreadPoolExecutor] = None
        self.last_drain = None    # the DrainReport of the last tick's drain

    # ------------------------------------------------------------- lifecycle
    @property
    def _pool(self) -> ThreadPoolExecutor:
        if self._pool_obj is None:
            self._pool_obj = ThreadPoolExecutor(
                max_workers=self.fetch_workers,
                thread_name_prefix="serve-fetch")
        return self._pool_obj

    def close(self) -> None:
        if self._pool_obj is not None:
            self._pool_obj.shutdown(wait=True)
            self._pool_obj = None

    def __enter__(self) -> "ReadFrontEnd":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ----------------------------------------------------- health machinery
    def health(self, phys: int) -> NodeHealth:
        if phys not in self._health:
            self._health[phys] = NodeHealth()
        return self._health[phys]

    def quarantined_nodes(self) -> list[int]:
        return sorted(p for p, h in self._health.items() if h.quarantined)

    def _log(self, what: str, **fields) -> None:
        self.events.append({"seq": len(self.events), "what": what, **fields})

    def _suspect(self, phys: int, weight: float, reason: str) -> None:
        h = self.health(phys)
        h.suspicion += weight
        if not h.quarantined and h.suspicion >= self.quarantine_threshold:
            h.quarantined = True
            self.metrics.quarantines += 1
            self._log("quarantine", node=phys, reason=reason,
                      suspicion=round(h.suspicion, 3))

    def _avoid_reasons(self) -> dict[int, str]:
        """Physical nodes helper selection demotes, worst reason wins:
        quarantined (integrity) > heartbeat dead/straggler > learned-slow
        (EWMA above the hedge threshold).  Demoted nodes are still used
        as a LAST resort when fewer than k preferred shares are
        readable — graceful degradation beats refusal."""
        avoid: dict[int, str] = {}
        if self.heartbeat is not None:
            sus = self.heartbeat.suspects(self.heartbeat_clock())
            for phys in sus["dead"]:
                if 1 <= phys <= self.store.n_nodes:
                    avoid[phys] = "dead-heartbeat"
            for phys in sus["stragglers"]:
                if 1 <= phys <= self.store.n_nodes:
                    avoid.setdefault(phys, "straggler")
        for phys, h in self._health.items():
            if h.quarantined:
                avoid[phys] = "quarantined"
            elif self.hedge_after_s is not None \
                    and h.ewma_read_s is not None \
                    and h.ewma_read_s > self.hedge_after_s:
                avoid.setdefault(phys, "slow")
        return avoid

    def scrub_quarantined(self) -> list[dict]:
        """Targeted scrub of every quarantined node whose slot is up: a
        clean scrub re-admits (suspicion reset); a dirty one drops the
        rotten shares as erasures, queues their repairs, and keeps the
        node quarantined until a later scrub comes back clean
        (DESIGN.md §13.3)."""
        out = []
        for phys in sorted(self._health):
            h = self._health[phys]
            if not h.quarantined or not self.store.is_up(phys):
                continue
            bad = self.store.scrub_node(phys)
            h.scrubs += 1
            if bad:
                for key, t in bad:
                    self.store.drop_share(phys, key, t)
                    if self.scheduler is not None:
                        self.scheduler.enqueue_stripe(key, t)
                self._log("scrub_dirty", node=phys, dropped=len(bad))
            else:
                h.quarantined = False
                h.suspicion = 0.0
                h.readmissions += 1
                self.metrics.readmissions += 1
                self._log("readmit", node=phys)
            out.append({"node": phys, "bad_shares": len(bad),
                        "readmitted": not h.quarantined})
        return out

    # ------------------------------------------------------------ admission
    def submit(self, key: str, *, priority: int = 0,
               deadline_s: Optional[float] = None) -> ReadTicket:
        """Admit a read (or shed the lowest-priority request in sight if
        the queue is full).  Returns the ticket; a shed ticket is
        already ``done`` with a typed :class:`Overloaded` error."""
        self._uid += 1
        tk = ReadTicket(uid=self._uid, key=key, priority=int(priority),
                        deadline_s=self.default_deadline_s
                        if deadline_s is None else float(deadline_s),
                        submitted_t=self.clock())
        self.metrics.requests += 1
        if len(self._queue) < self.max_queue:
            self._queue.append(tk)
            return tk
        # full: shed the lowest-priority request (newest loses ties, so
        # an incoming request never bumps an equal-priority queued one)
        victim = min(self._queue, key=lambda r: (r.priority, -r.uid))
        if (tk.priority, -tk.uid) <= (victim.priority, -victim.uid):
            victim = tk
        else:
            self._queue.remove(victim)
            self._queue.append(tk)
        victim.done = True
        victim.error = Overloaded(victim.key, victim.priority,
                                  len(self._queue))
        victim.receipt = ReadReceipt(key=victim.key,
                                     deadline_s=victim.deadline_s,
                                     deadline_met=False)
        self.metrics.shed += 1
        self._log("shed", key=victim.key, priority=victim.priority)
        return tk

    def read(self, key: str, *, priority: int = 0,
             deadline_s: Optional[float] = None) -> Any:
        """Convenience: submit + pump + result (raises the typed error
        on shed or data loss)."""
        return self.read_ext(key, priority=priority,
                             deadline_s=deadline_s).result()

    def read_ext(self, key: str, *, priority: int = 0,
                 deadline_s: Optional[float] = None) -> ReadTicket:
        tk = self.submit(key, priority=priority, deadline_s=deadline_s)
        if not tk.done:
            self.pump()
        return tk

    # ----------------------------------------------------------- serve loop
    def pump(self) -> list[ReadTicket]:
        """Serve everything admitted so far: coalesce tickets per key,
        read each key once, coalesce degraded stripes across ALL keys
        by failure pattern into one planned decode dispatch each, then
        resolve every ticket.  Returns the batch."""
        batch, self._queue = self._queue, []
        if not batch:
            return []
        batch.sort(key=lambda r: (-r.priority, r.uid))
        by_key: dict[str, list[ReadTicket]] = {}
        for tk in batch:
            by_key.setdefault(tk.key, []).append(tk)
        self._serve(by_key)
        return batch

    def _serve(self, by_key: dict[str, list[ReadTicket]]) -> None:
        store = self.store
        avoid = self._avoid_reasons()
        plans: dict[str, dict] = {}
        groups: dict[tuple, list[tuple[str, int]]] = {}
        downloads: dict[tuple[str, int], np.ndarray] = {}
        for key, tickets in by_key.items():
            try:
                stat = store.stat(key)
            except KeyError as e:           # includes UnknownKeyError
                self._fail_tickets(tickets, e)
                continue
            cc = getattr(stat, "code_class", None)
            if cc is not None and cc != store.default_class:
                # non-default code family (DESIGN.md §15.1): the hedged /
                # cross-key-coalesced machinery below is specific to the
                # default class's share geometry — serve through the
                # store's family-generic degraded read path instead
                self._serve_generic(key, tickets)
                continue
            plan = {"stat": stat, "tickets": tickets,
                    "deadline_end": max(tk.submitted_t + tk.deadline_s
                                        for tk in tickets),
                    "blocks": np.zeros((stat.n_stripes, store.n, store.S),
                                       np.int32),
                    "degraded": 0, "hedged": 0, "crc_rejected": 0,
                    "patterns": 0, "avoided": set()}
            try:
                # the key's share fetches and CRC checks: one clock record
                with tallied("fe_fetch"):
                    for t in range(stat.n_stripes):
                        with staged("fe_fetch"):
                            pattern, dl = self._read_stripe(key, t, plan,
                                                            avoid)
                        if pattern is not None:
                            groups.setdefault(pattern, []).append((key, t))
                            downloads[(key, t)] = dl
                            plan["degraded"] += 1
            except RuntimeError as e:       # < k readable shares
                store.metrics.record_read("failed", 0.0, 0)
                self._fail_tickets(tickets, e)
                continue
            plans[key] = plan

        if groups:
            S = store.S
            planner = getattr(store.code, "planner", None)

            def gather(item):
                # the pattern's downloads land side by side in one pooled
                # (pinned, on the card) buffer that the decode reads as
                # it lies
                _pattern, refs = item
                buf = store._stage_into(planner, 2 * store.k, len(refs) * S)
                if buf is None:
                    return np.concatenate([downloads[r] for r in refs],
                                          axis=1)
                for g, r in enumerate(refs):
                    buf[:, g * S:(g + 1) * S] = downloads[r]
                return buf

            def decode(item, dl):
                (helpers, missing), _refs = item
                mat = store.code.repair.decode_matrix(helpers)
                return store.code.repair.apply_planned(mat[list(missing)],
                                                       dl), dl

            def scatter(item, res) -> None:
                (_helpers, missing), refs = item
                planned, dl = res
                dec = planned.host()
                if planner is not None:
                    planner.staging.release(dl)
                for g, (key, t) in enumerate(refs):
                    plans[key]["blocks"][t, list(missing)] = \
                        dec[:, g * S:(g + 1) * S]

            with staged("fe_decode"):
                store.pipeline.map(list(groups.items()), decode, scatter,
                                   read=gather)
            self.metrics.decode_dispatches += len(groups)
            for _pattern, refs in groups.items():
                for key in {k for k, _t in refs}:
                    plans[key]["patterns"] += 1

        for key, plan in plans.items():
            self._resolve_key(key, plan)

    def _read_stripe(self, key: str, t: int, plan: dict,
                     avoid: dict[int, str]):
        """Fetch stripe (key, t): preferred (non-demoted) nodes first
        under the hedge/deadline budget, demoted nodes as a blocking
        last resort only while fewer than k shares are readable.
        Fills the systematic blocks; returns the ((helpers, missing)
        pattern, (2k, S) downloads) when a decode is needed, else
        (None, None)."""
        store = self.store
        pl = store.placement_of(key, t)
        present = sorted(store.present_code_nodes(key, t))
        pref = [j for j in present if pl[j - 1] not in avoid]
        fall = [j for j in present if pl[j - 1] in avoid]
        # soft-demoted (slow/straggler) nodes outrank quarantined ones
        fall.sort(key=lambda j: (avoid[pl[j - 1]] == "quarantined", j))
        plan["avoided"].update(pl[j - 1] for j in fall)
        fetched: dict[int, list] = {}
        for j in pref:
            share = self._fetch_checked(pl[j - 1], key, t, plan)
            if share is not None:
                fetched[j] = share
        for j in fall:
            if len(fetched) >= store.k:
                break
            share = self._fetch_checked(pl[j - 1], key, t, plan, must=True)
            if share is not None:
                fetched[j] = share
        if len(fetched) < store.k:
            raise RuntimeError(
                f"data loss: stripe {t} of {key!r} has only "
                f"{len(fetched)} readable of k={store.k} shares")
        for j, share in fetched.items():
            plan["blocks"][t, j - 1] = share[1]
        missing = tuple(j for j in range(store.n) if j + 1 not in fetched)
        if not missing:
            lat = store.link.fetch_s(store.S)
            store.metrics.record_read("systematic", lat, store.n * store.S)
            return None, None
        helpers = tuple(sorted(fetched)[: store.k])
        dl = np.concatenate(
            [np.stack([fetched[j][1] for j in helpers]),
             np.stack([fetched[j][2] for j in helpers])], axis=0)
        lat = store.link.degraded_read_s(2 * store.S, [1.0] * store.k)
        store.metrics.record_read("degraded", lat, 2 * store.k * store.S)
        return (helpers, missing), dl

    def _fetch_checked(self, phys: int, key: str, t: int, plan: dict,
                      must: bool = False) -> Optional[list]:
        """One share fetch + end-to-end CRC check.  Returns the share or
        None (absent, hedged past, gave up, or failed its CRC — in
        which case the caller decodes around it).  A mismatch whose
        STORED copy is intact is a read-path flip: the fetch is retried
        up to ``_CRC_REREADS`` times before giving the share up.
        ``must`` fetches (last-resort helpers) ignore the hedge and
        deadline: serving late beats refusing."""
        store = self.store
        h = self.health(phys)
        for _attempt in range(1 + _CRC_REREADS):
            share = self._fetch_once(phys, key, t, plan, must)
            if share is None:
                return None
            if self._crc_ok(plan["stat"], t, share):
                return share
            # integrity failure: erasure candidate, suspicion always;
            # drop + enqueue repair only when the STORED copy is rotten
            h.crc_failures += 1
            plan["crc_rejected"] += 1
            self.metrics.crc_rejected += 1
            self._suspect(phys, self.crc_weight, "crc mismatch")
            if store.share_intact(phys, key, t) is False:
                store.drop_share(phys, key, t)
                if self.scheduler is not None:
                    self.scheduler.enqueue_stripe(key, t)
                self._log("crc_drop", node=phys, key=key, stripe=t)
                return None
            self._log("crc_transient", node=phys, key=key, stripe=t)
        return None

    def _fetch_once(self, phys: int, key: str, t: int, plan: dict,
                    must: bool) -> Optional[list]:
        """One raw share fetch under the hedge/deadline machinery (no
        CRC): the share, or None when absent, hedged past, or the retry
        policy gave up."""
        store = self.store
        h = self.health(phys)
        t0 = self.clock()
        budget = None if must \
            else max(0.0, plan["deadline_end"] - t0)
        if store.faults is None:
            # nothing can stall an in-memory read: fetch inline
            try:
                share = store.read_share(phys, key, t)
            except KeyError:
                return None
            h.observe(self.clock() - t0)
            return share
        timeout = None if must else self.hedge_after_s
        if timeout is not None:
            timeout = min(timeout, max(budget, _MIN_PATIENCE_S))
        fut = self._pool.submit(store.read_share, phys, key, t,
                                budget_s=budget)
        try:
            share = fut.result(timeout=timeout)
        except _FutureTimeout:
            h.timeouts += 1
            plan["hedged"] += 1
            self.metrics.hedged_fetches += 1
            self._suspect(phys, self.hedge_weight, "hedged past")
            fut.add_done_callback(
                lambda f, p=phys, s=t0: self._observe_late(p, s, f))
            return None
        except GiveUpError:
            h.giveups += 1
            self._suspect(phys, self.giveup_weight, "retry give-up")
            return None
        except KeyError:
            return None
        h.observe(self.clock() - t0)
        return share

    def _observe_late(self, phys: int, t0: float, fut) -> None:
        # a hedged-past fetch that eventually lands still teaches the
        # latency model how slow the node really is
        if fut.exception() is None:
            self.health(phys).observe(self.clock() - t0)

    @staticmethod
    def _crc_ok(stat: ObjectStat, t: int, share: list) -> bool:
        if stat.share_crcs is None:
            return True
        return share_crc(share[1], share[2]) == \
            stat.share_crcs[t][share[0] - 1]

    def _serve_generic(self, key: str, tickets: list) -> None:
        """Serve a non-default-code-class key through the store's
        family-generic read path (systematic reuse + grouped decode),
        resolving tickets with a receipt built from the GetResult."""
        try:
            res = self.store.get_ext(key)
        except (KeyError, RuntimeError) as e:
            self.store.metrics.record_read("failed", 0.0, 0)
            self._fail_tickets(tickets, e)
            return
        for tk in tickets:
            wall = self.clock() - tk.submitted_t
            met = wall <= tk.deadline_s
            tk.obj = res.obj
            tk.receipt = ReadReceipt(
                key=key, wall_latency_s=wall, deadline_s=tk.deadline_s,
                deadline_met=met, degraded_stripes=res.degraded_stripes,
                coalesced=len(tickets))
            tk.done = True
            self.metrics.served += 1
            self.metrics.wall_latencies.append(wall)
            if not met:
                self.metrics.deadline_misses += 1
        self.metrics.coalesced_requests += len(tickets) - 1
        self.metrics.degraded_stripes += res.degraded_stripes
        self.metrics.stripes_read += self.store.stat(key).n_stripes

    def _resolve_key(self, key: str, plan: dict) -> None:
        obj = self.store.materialize(plan["stat"], plan["blocks"])
        tickets = plan["tickets"]
        for tk in tickets:
            wall = self.clock() - tk.submitted_t
            met = wall <= tk.deadline_s
            tk.obj = obj
            tk.receipt = ReadReceipt(
                key=key, wall_latency_s=wall, deadline_s=tk.deadline_s,
                deadline_met=met, degraded_stripes=plan["degraded"],
                hedged_fetches=plan["hedged"],
                crc_rejected=plan["crc_rejected"],
                coalesced=len(tickets),
                decode_dispatches=plan["patterns"],
                avoided_nodes=tuple(sorted(plan["avoided"])))
            tk.done = True
            self.metrics.served += 1
            self.metrics.wall_latencies.append(wall)
            if not met:
                self.metrics.deadline_misses += 1
        self.metrics.coalesced_requests += len(tickets) - 1
        self.metrics.degraded_stripes += plan["degraded"]
        self.metrics.stripes_read += plan["stat"].n_stripes

    def _fail_tickets(self, tickets: list[ReadTicket],
                      err: BaseException) -> None:
        for tk in tickets:
            tk.error = err
            tk.done = True
            tk.receipt = ReadReceipt(key=tk.key,
                                     wall_latency_s=self.clock()
                                     - tk.submitted_t,
                                     deadline_s=tk.deadline_s,
                                     deadline_met=False)
            self.metrics.failed += 1

    # ------------------------------------------------------------ tick loop
    def tick(self, repair_budget_symbols: Optional[int] = None) -> dict:
        """One serving tick: pump admitted requests, scrub/re-admit
        quarantined nodes, then let the repair scheduler drain one
        bandwidth-throttled tick — foreground serving and background
        repair contend under the same :class:`LinkModel` budget (the
        scheduler's ``repair_bandwidth_fraction`` is repair's slice).
        The drain's :class:`DrainReport` is kept as ``last_drain`` (None
        when the tick drained nothing)."""
        with staged("tick_pump"):
            served = self.pump()
        scrubs = self.scrub_quarantined()
        repaired = remaining = 0
        self.last_drain = None
        if self.scheduler is not None and self.scheduler.pending():
            with staged("tick_drain"):
                rep = self.scheduler.drain(repair_budget_symbols)
            self.last_drain = rep
            repaired, remaining = rep.repaired_stripes, rep.remaining
        return {"served": len(served), "scrubbed": len(scrubs),
                "repaired_stripes": repaired,
                "repair_remaining": remaining}


__all__ = ["ReadFrontEnd", "ReadTicket", "ReadReceipt", "NodeHealth",
           "FrontEndMetrics", "Overloaded"]
