"""Repair under load: lost nodes are rebuilt through the read front
end's ``tick`` while open-loop reads and updates keep arriving.

Operations come due as in ``open_loop`` (``traffic_gen.open_schedule``):
``rate_per_s`` Poisson arrivals, ``read_share`` of them reads and the
rest updates (a put of a fresh payload of the key's size), keys from
YCSB's scrambled zipfian with ``zipfian_constant``.  One dispatcher
thread loops: it admits the reads that are due (``submit``), runs an
update that is due once the reads due before it are served, and calls
``tick(repair_budget_symbols)``, which pumps the front end (answering
every read admitted) and then drains one throttled tick of the repair
scheduler.  When the scheduler has nothing pending, the node in flight
counts as rebuilt and the next node of an order drawn from the seed
fails and is replaced: one node is lost at a time.  The window closes
with the tick that crosses the deadline.  A read's latency runs from
when it was due to the end of the pump that answered it.

Set-up fills the store, subscribes the scheduler, builds the front end
over it, fails and replaces the first node of the order and drains it
through ``tick`` (which warms every repair shape), then runs
``warmup_s`` seconds of the same loop and lets the node it left in
flight finish, so that the window opens on the next node.  After the
window the shares of the node in flight that the store holds count as
rebuilt and its drain may finish (``repair_loop``'s ``finish``); every
read is checked against the payload its key held when it was served
(``open_loop``'s ``check``), and every share against the reference.

Mix parameters: ``rate_per_s``, ``read_share``, ``zipfian_constant``,
``repair_budget_symbols`` (the symbols one tick's drain may move),
``warmup_s``.
"""
import dataclasses
import sys
import time
from typing import Optional

from perfbench import deploy, harness, traffic_gen
from perfbench.profile_reduce import span

# the closed repair loop and the open read loop, whose finish, check,
# close, read accounting and planted faults this driver shares
_REPAIR = harness.load_driver("repair_loop")
_READS = harness.load_driver("open_loop")
# the front end's counters the window reports, where the program has them
FE_COUNTERS = ("requests", "served", "failed", "shed", "coalesced_requests",
               "deadline_misses", "hedged_fetches", "crc_rejected",
               "decode_dispatches", "degraded_stripes", "stripes_read")


def setup(cell) -> None:
    from repro_torch.serve.frontend import ReadFrontEnd
    cell.fill()
    cell.sched = deploy.build_scheduler(cell.store)
    # deploy.build_frontend's arguments, and the scheduler its tick drains
    fe = cell.cfg["frontend"]
    cell.fe = ReadFrontEnd(cell.store, scheduler=cell.sched,
                           default_deadline_s=float(fe["deadline_s"]),
                           hedge_after_s=fe["hedge_after_s"],
                           max_queue=int(fe["max_queue"]),
                           fetch_workers=int(fe["fetch_workers"]))
    cell.budget = int(cell.mix["repair_budget_symbols"])
    cell.order = traffic_gen.node_order(cell.n_nodes, cell.seed)
    cell.nxt = 0
    cell.node = None                       # the node in flight
    cell.open_node = None                  # the node in flight at the close
    cell.answers = []                      # (got, want, error) per read
    warm = traffic_gen.open_schedule(cell.mix, len(cell.keys),
                                     float(cell.mix["warmup_s"]), cell.seed,
                                     _READS.WARM_STREAMS)
    cell.schedule = traffic_gen.open_schedule(cell.mix, len(cell.keys),
                                              cell.seconds, cell.seed)
    gen = traffic_gen.rng(cell.seed, traffic_gen.STREAM_UPDATES)
    cell.payloads = [traffic_gen.payload(gen, cell.sizes[op.key])
                     for op in warm + cell.schedule if op.kind == "put"]
    lose_next(cell, record=False)
    settle(cell)
    if warm:
        serve(cell, warm, record=False)
        settle(cell)


def window(cell, t0: float, seconds: float) -> None:
    m0 = fe_counters(cell.fe)
    rec = cell.rec
    rec.counters["tick"] = {"ticks": 0, "drain_ticks": 0, "nodes": 0,
                            "updates": 0}
    rec.counters["reads"] = {"bytes": 0}
    serve(cell, cell.schedule, record=True, t0=t0, seconds=seconds)
    m1 = fe_counters(cell.fe)
    rec.counters["fe"] = {k: m1[k] - m0[k] for k in m1}
    cell.open_node = cell.node


finish, check, close = _REPAIR.finish, _READS.check, _READS.close


def fe_counters(fe) -> dict:
    """The front end's counters (those this program has)."""
    return {k: getattr(fe.metrics, k) for k in FE_COUNTERS
            if hasattr(fe.metrics, k)}


def lose_next(cell, record: bool) -> None:
    """Fail and replace the next node of the order: the node in flight."""
    node = cell.order[cell.nxt % len(cell.order)]
    cell.nxt += 1
    cell.node_lost = cell.fail_replace(node)
    cell.node_shares = cell.ledger.shares_on(node)
    cell.node = node
    if record:
        cell.attempted += cell.node_lost


def node_done(cell, record: bool) -> None:
    """The node in flight has nothing pending: its shares count as
    rebuilt."""
    if record and cell.node is not None:
        cell.rec.rebuilt_shares += cell.node_lost
        cell.rec.counters["tick"]["nodes"] += 1
    cell.node = None


def settle(cell) -> None:
    """Tick, serving nothing, until the node in flight is rebuilt, while
    each tick rebuilds something and for up to ``repair_loop.FINISH_S``:
    a store whose scrubs keep dropping what its repairs wrote (as under
    the control) never settles, and the check finds what is wrong."""
    t_end = time.perf_counter() + _REPAIR.FINISH_S
    while cell.sched.pending() and time.perf_counter() < t_end:
        if not cell.fe.tick(cell.budget)["repaired_stripes"]:
            break
    node_done(cell, record=False)


def serve(cell, ops: list, *, record: bool, t0: Optional[float] = None,
          seconds: Optional[float] = None) -> None:
    """Serve ``ops`` as they come due while the lost nodes drain, on one
    dispatcher thread.  With ``seconds``, close with the tick that
    crosses it; without, once every operation has been served."""
    fe, keys = cell.fe, cell.keys
    t0 = time.perf_counter() if t0 is None else t0
    drain: dict = cell.rec.drain if record else {}
    i, n = 0, len(ops)
    while True:
        now = time.perf_counter() - t0
        pending: list = []                  # (op, ticket, admitted at)
        while i < n and ops[i].kind == "get" and ops[i].due_s <= now:
            op = ops[i]
            with span("submit", cell.trace):
                tk = fe.submit(keys[op.key])
            if tk.done:                       # shed at admission
                _READS._answer(cell, op, tk, None, now, now, record)
            else:
                pending.append((op, tk, now))
            i += 1
            now = time.perf_counter() - t0
        if not pending and i < n and ops[i].kind == "put" \
                and ops[i].due_s <= now:
            _update(cell, keys[ops[i].key], record)
            i += 1
            continue
        if cell.sched.pending() == 0:
            node_done(cell, record)
            lose_next(cell, record)
        held = {op.key: cell.ledger.objs[keys[op.key]]
                for op, _tk, _at in pending}
        ps = time.perf_counter() - t0
        fault = None
        with span("tick", cell.trace):
            try:
                fe.tick(cell.budget)
            except Exception as e:  # counted; the check judges
                print(f"tick failed: {e!r}", file=sys.stderr)
                fault = e
        # the tick's DrainReport (none where the pump raised before it)
        rep = None if fault is not None else getattr(fe, "last_drain", None)
        for op, tk, at in pending:
            want = held[op.key].payload
            # served at the end of the pump that answered it: its
            # receipt's latency after admission
            ok = tk.done and tk.error is None
            end = at + tk.receipt.wall_latency_s if ok else ps
            _READS._answer(cell, op, tk, want, ps, end, record, fault)
            if record and ok:
                cell.rec.counters["reads"]["bytes"] += len(want)
        if record:
            counts = cell.rec.counters["tick"]
            counts["ticks"] += 1
            counts["drain_ticks"] += rep is not None
            cell.failed += fault is not None and all(
                tk.done for _op, tk, _at in pending)
        if rep is not None:
            for f in dataclasses.fields(rep):
                drain[f.name] = drain.get(f.name, 0) + getattr(rep, f.name)
        if seconds is not None:
            if time.perf_counter() - t0 >= seconds:
                return
        elif i >= n:
            return


def _update(cell, key: str, record: bool) -> None:
    obj = cell.ledger.objs.get(key)
    with span("update", cell.trace):
        ok = cell.put(key, cell.payloads.pop(0),
                      0 if obj is None else obj.version + 1)
    if record:
        cell.attempted += 1
        cell.failed += not ok
        cell.rec.counters["tick"]["updates"] += 1


# the faults of the two steps this driver times: the drain's (as in
# repair_loop) and the pump's (as in open_loop)
FAULTS = {"unchanged": _REPAIR.FAULTS["unchanged"],
          "half": _REPAIR.FAULTS["half"],
          "pump_unchanged": _READS.FAULTS["unchanged"],
          "pump_half": _READS.FAULTS["half"]}
