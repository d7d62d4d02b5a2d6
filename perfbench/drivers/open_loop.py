"""Open-loop reads (and updates) through the program's read front end.

Operations come due on a schedule (``traffic_gen.open_schedule``):
``rate_per_s`` Poisson arrivals, ``read_share`` of them reads and the
rest updates (a put of a fresh payload of the key's size), keys from
YCSB's scrambled zipfian with ``zipfian_constant``.  One dispatcher
thread admits the reads due, pumps the front end, and runs an update
once the reads due before it are served.  Each read's latency runs from
when it was due to the end of the pump that answered it.

Set-up fills the store, fails the nodes in ``lost_nodes`` (they stay
lost), builds the front end and runs ``warmup_s`` seconds of the same
traffic.  After the window, every read's bytes are checked against the
payload its key held when the read was served.

Mix parameters: ``rate_per_s``, ``read_share``, ``zipfian_constant``,
``lost_nodes``, ``warmup_s``.
"""
import sys
import time
from typing import Optional

from perfbench import deploy, traffic_gen, verify
from perfbench.profile_reduce import span

WARM_STREAMS = 100       # stream offset of the warm-up schedule


def setup(cell) -> None:
    cell.fill()
    for node in cell.mix["lost_nodes"]:
        cell.store.fail_node(node)
        cell.lost.add(node)
    cell.fe = deploy.build_frontend(cell.cfg, cell.store)
    cell.answers = []                      # (got, want, error) per read
    warm = traffic_gen.open_schedule(cell.mix, len(cell.keys),
                                     float(cell.mix["warmup_s"]), cell.seed,
                                     WARM_STREAMS)
    cell.schedule = traffic_gen.open_schedule(cell.mix, len(cell.keys),
                                              cell.seconds, cell.seed)
    gen = traffic_gen.rng(cell.seed, traffic_gen.STREAM_UPDATES)
    cell.payloads = [traffic_gen.payload(gen, cell.sizes[op.key])
                     for op in warm + cell.schedule if op.kind == "put"]
    serve(cell, warm, record=False)


def window(cell, t0: float, seconds: float) -> None:
    serve(cell, cell.schedule, record=True, t0=t0)


def check(cell) -> dict:
    from repro_torch.serve.frontend import Overloaded
    return verify.check_reads(cell.answers, Overloaded)


def close(cell) -> None:
    if getattr(cell, "fe", None) is not None:
        cell.fe.close()


def serve(cell, ops: list, *, record: bool,
          t0: Optional[float] = None) -> None:
    """Serve ``ops`` as they come due on one dispatcher thread."""
    fe, rec, keys = cell.fe, cell.rec, cell.keys
    t0 = time.perf_counter() if t0 is None else t0
    pending: list = []           # (op, ticket)
    i, n = 0, len(ops)
    while i < n or pending:
        now = time.perf_counter() - t0
        while i < n and ops[i].kind == "get" and ops[i].due_s <= now:
            op = ops[i]
            with span("submit", cell.trace):
                tk = fe.submit(keys[op.key])
            if tk.done:                       # shed at admission
                _answer(cell, op, tk, None, now, now, record)
            else:
                pending.append((op, tk))
            i += 1
            now = time.perf_counter() - t0
        if pending:
            held = {op.key: cell.ledger.objs[keys[op.key]]
                    for op, _tk in pending}
            ps = time.perf_counter() - t0
            fault = None
            with span("pump", cell.trace):
                try:
                    fe.pump()
                except Exception as e:  # its reads are answered wrong
                    print(f"pump failed: {e!r}", file=sys.stderr)
                    fault = e
            pe = time.perf_counter() - t0
            for op, tk in pending:
                _answer(cell, op, tk, held[op.key].payload, ps, pe, record,
                        fault)
            if record:
                rec.pump_s += pe - ps
                if cell.lost:
                    for key in {keys[op.key] for op, _tk in pending}:
                        st, bl = cell.ledger.degraded(key, cell.lost)
                        rec.decode_stripes += st
                        rec.decode_blocks += bl
            pending = []
            continue
        if i < n and ops[i].kind == "put" and ops[i].due_s <= now:
            key = keys[ops[i].key]
            obj = cell.ledger.objs.get(key)
            with span("update", cell.trace):
                ok = cell.put(key, cell.payloads.pop(0),
                              0 if obj is None else obj.version + 1)
            if record:
                cell.attempted += 1
                cell.failed += not ok
            i += 1
            continue
        if i < n:
            wait = ops[i].due_s - (time.perf_counter() - t0)
            if wait > 0:
                with span("wait", cell.trace):
                    time.sleep(wait)


def _answer(cell, op, tk, want, start: float, end: float, record: bool,
            fault: Optional[Exception] = None) -> None:
    """Record one read's outcome (``fault``: what its pump raised)."""
    if not record:
        return
    cell.attempted += 1
    err = tk.error if tk.done else (fault or RuntimeError("not answered"))
    if err is None:
        cell.rec.read_ms.append((end - op.due_s) * 1e3)
        cell.rec.wait_ms.append((start - op.due_s) * 1e3)
        cell.rec.reads_served += 1
        cell.answers.append((tk.obj, want, None))
        return
    cell.failed += 1
    cell.rec.read_ms.append(None)
    cell.answers.append((None, want, err))


def _pump_faulty(fault: str):
    """A pump that serves nothing, or drops the back half of its queue."""
    from repro_torch.serve.frontend import ReadFrontEnd
    orig = ReadFrontEnd.pump

    def pump(self):
        if fault == "unchanged":
            return []
        self._queue = self._queue[: len(self._queue) // 2]
        return orig(self)
    return ReadFrontEnd, "pump", pump


FAULTS = {"unchanged": lambda: _pump_faulty("unchanged"),
          "half": lambda: _pump_faulty("half")}
