"""Closed-loop repair: one node after another fails, is replaced by an
empty newcomer and is rebuilt by the program's repair scheduler from
d = k+1 helpers, in an order drawn from the seed.

Set-up fills the store with an object of each key's size made from the
seed, then fails and rebuilds the first node of the order, which warms
every repair shape.  The window fails the next node, drains it tick by
tick, and goes on to the next once nothing is pending; it closes with
the tick that crosses the deadline.  After the window the shares of the
node in progress that the store holds count as rebuilt, and its drain
may finish for up to ``FINISH_S``.

Mix parameters: none beyond ``driver``.
"""
import dataclasses
import sys
import time

from perfbench import deploy, traffic_gen, verify
from perfbench.profile_reduce import span

FINISH_S = 60.0          # how long past the close outstanding work may take


def setup(cell) -> None:
    cell.fill()
    cell.sched = deploy.build_scheduler(cell.store)
    cell.order = traffic_gen.node_order(cell.n_nodes, cell.seed)
    cell.fail_replace(cell.order[0])
    cell.sched.drain_all()                # warms every repair shape
    cell.open_node = None


def window(cell, t0: float, seconds: float) -> None:
    rec, sched = cell.rec, cell.sched
    nxt, node, lost = 1, None, 0
    drain: dict = {}
    while True:
        if node is None or sched.pending() == 0:
            if node is not None:
                rec.rebuilt_shares += lost
                node = None
            if time.perf_counter() - t0 >= seconds:
                break
            node = cell.order[nxt % len(cell.order)]
            nxt += 1
            lost = cell.fail_replace(node)
            cell.attempted += lost
            cell.node_shares = cell.ledger.shares_on(node)
        if time.perf_counter() - t0 >= seconds:
            break
        with span("drain_tick", cell.trace):
            try:
                rep = sched.drain()
            except Exception as e:          # counted; the check judges
                print(f"drain failed: {e!r}", file=sys.stderr)
                cell.failed += 1
                continue
        for f in dataclasses.fields(rep):
            drain[f.name] = drain.get(f.name, 0) + getattr(rep, f.name)
    rec.drain = drain
    cell.open_node = node


def finish(cell) -> None:
    """Count the in-flight drain's progress at the close, then let the
    outstanding repairs finish (up to FINISH_S, and only while each tick
    rebuilds something)."""
    if cell.open_node is not None:
        cell.rec.rebuilt_shares += verify.present(
            cell.store, cell.node_shares, cell.open_node)
    t_end = time.perf_counter() + FINISH_S
    while cell.sched.pending() and time.perf_counter() < t_end:
        try:
            if not cell.sched.drain().repaired_stripes:
                break                   # stalled: the rest will not come
        except Exception as e:
            print(f"drain failed: {e!r}", file=sys.stderr)
            break


def _drain_faulty(fault: str):
    """A drain tick that leaves out all (``unchanged``) or every other
    (``half``) queued repair.  The whole tick is broken, so that no other
    repair path (a later multi-loss decode) can quietly redo what the
    fault left out."""
    from repro_torch.store import DrainReport, RepairScheduler
    orig = RepairScheduler.drain

    def drain(self, budget_symbols=None):
        queued = sorted(self._queued)
        left_out = queued if fault == "unchanged" else queued[::2]
        self._queued.difference_update(left_out)
        if fault == "unchanged":
            self._heap.clear()
            return DrainReport(repaired_stripes=len(queued),
                               repaired_shares=len(queued))
        return orig(self, budget_symbols)
    return RepairScheduler, "drain", drain


# the faults the step this driver times can have: (owner, attribute,
# replacement) to patch in; an altered symbol is common to all drivers
FAULTS = {"unchanged": lambda: _drain_faulty("unchanged"),
          "half": lambda: _drain_faulty("half")}
