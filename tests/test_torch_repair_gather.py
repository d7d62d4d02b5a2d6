"""The coalesced repair's helper gather (`CodedObjectStore.
repair_stripes_embedded`): each window's operands are preallocated and
filled row by row, in place, by the gathering thread and up to
``io_workers - 1`` pool threads (`Pipeline.fan_out`).

Held here, on the CPU: every pool size, depth and window width rebuilds
the same shares, reports the same ``DrainReport`` and records the same
stage calls as the serial gather and as the reference, with every object
double-circulant and with one product-matrix object among them (its
windows gathered the same way); a helper rotten
in storage and met by another thread skips and requeues the tick as the
reference does, with every staging buffer back in the pool; several
windows in one tick never deadlock; and `Pipeline.fan_out` itself runs
each task once, raises the serial loop's error and completes with no
pool thread free.  The store fans out only from
``GATHER_FAN_OUT_MIN_SYMBOLS``; these tests lower it to their small
stripes, and one holds the rule itself."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

import repro.codes as rcodes
import repro.store as rstore
import repro_torch.codes as tcodes
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.core.circulant import CodeSpec as TSpec
from repro_torch.exec import staging
from repro_torch.exec.pipeline import Pipeline
from repro_torch.store import CodedObjectStore, RepairScheduler
from repro_torch.store import object_store
from repro_torch.store.object_store import ShareIntegrityError

K, NODES, S = 4, 12, 64
LOST = 5
TASKS = 15          # shares the lost node held
PM = ("product-matrix", 8, 4, 6)
DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def fan_out_at_small_stripes(monkeypatch):
    """The fan-out at this file's stripes of S symbols."""
    monkeypatch.setattr(object_store, "GATHER_FAN_OUT_MIN_SYMBOLS", S)


def blob(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def build(pkg="port", mixed=False, **kw):
    """A store of 3 objects with node LOST failed and replaced; with
    ``mixed``, the first object is product-matrix (class PM)."""
    if pkg == "port":
        store = CodedObjectStore(TSpec.make(K, 257), n_nodes=NODES,
                                 stripe_symbols=S, device="cpu", **kw)
        sched = RepairScheduler(store)
        codes = tcodes
    else:
        store = rstore.CodedObjectStore(RSpec.make(K, 257), n_nodes=NODES,
                                        stripe_symbols=S, **kw)
        sched = rstore.RepairScheduler(store)
        codes = rcodes
    store.subscribe(sched.on_event)
    # 3 objects, 23 stripes: the lost node holds TASKS of them
    for i, n in enumerate((9000, 2000, 500)):
        cc = codes.CodeClass(*PM) if mixed and i == 0 else None
        store.put(f"o{i}", blob(n, i), code_class=cc)
    store.fail_node(LOST)
    store.replace_node(LOST)
    return store, sched


def shares(store):
    return [{kt: (s[0],) + tuple(np.asarray(b, np.int32).tobytes()
                                 for b in s[1:])
             for kt, s in held.items()} for held in store._shares]


def report(rep):
    return dataclasses.asdict(rep)


def in_use(store):
    """Staging buffers handed out and not yet back, in the planner that
    every store of this code in the process shares (None for the
    reference)."""
    planner = getattr(store.code, "planner", None)
    return None if planner is None else planner.staging.stats().in_use


def lost_by_class(store):
    """The lost node's shares, counted by their object's code class."""
    counts = {}
    for key, _t in store.stripes_on(LOST):
        cc = store.class_of(key).key()
        counts[cc] = counts.get(cc, 0) + 1
    return counts


def drained(pkg="port", mixed=False, **kw):
    """Shares, the drain tick's report and the port's stage calls."""
    store, sched = build(pkg, mixed, **kw)
    with store:
        tasks = sum(lost_by_class(store).values())
        assert mixed or tasks == TASKS
        held = in_use(store)
        staging.reset_stage_times()
        rep = sched.drain()
        calls = staging.stage_calls()
        assert sched.pending() == 0 and rep.repaired_shares == tasks
        assert in_use(store) == held
        return shares(store), report(rep), calls


@pytest.fixture(scope="module")
def reference():
    """The reference's drain, per window width and mix of classes."""
    return {(tile, mixed): drained("ref", mixed, repair_tile_tasks=tile)[:2]
            for tile in (2, 3, 64) for mixed in (False, True)}


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("tile", [2, 3, 64])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_gather_matches_the_serial_gather_and_the_reference(
        workers, depth, tile, mixed, reference):
    # 15 tasks: windows of 2 (8 windows, the last of 1), of 3 (5) and of
    # 64 (1 of 15); no window count and no width divides by the workers.
    # Mixed, each class's tasks are windowed apart: product-matrix first
    got = drained(io_workers=workers, pipeline_depth=depth,
                  repair_tile_tasks=tile, mixed=mixed)
    serial = drained(io_workers=1, pipeline_depth=1, repair_tile_tasks=tile,
                     mixed=mixed)
    store, _sched = build(mixed=mixed)
    with store:
        counts = lost_by_class(store)
    assert len(counts) == 1 + mixed
    windows = sum(-(-n // tile) for n in counts.values())
    assert got[1]["batch_calls"] == windows
    assert got[0] == serial[0] == reference[tile, mixed][0]
    assert got[1] == serial[1] == reference[tile, mixed][1]
    assert got[2] == serial[2]
    assert got[2]["crc"] == got[2]["gather"] == windows


def test_fan_out_engages_only_with_overlap_and_no_injector():
    """The pool threads take part at depth 2 without a fault injector;
    depth 1 and an injector keep the gather on one thread."""
    from repro_torch.io import FaultInjector

    def threads(**kw):
        store, sched = build(**kw)
        seen = set()
        read = store._read_share_verified

        def spy(*a, **k):
            seen.add(threading.get_ident())
            time.sleep(0.002)           # long enough for a helper to start
            return read(*a, **k)

        store._read_share_verified = spy
        with store:
            assert sched.drain().repaired_shares == TASKS
        return len(seen)

    assert threads(io_workers=4, pipeline_depth=2) > 1
    assert threads(io_workers=4, pipeline_depth=1) == 1
    inj = FaultInjector(seed=0, sleep=lambda s: None)
    assert threads(io_workers=4, pipeline_depth=2, faults=inj) == 1


def test_stripe_units_below_the_bound_gather_on_one_thread(monkeypatch):
    """Below ``GATHER_FAN_OUT_MIN_SYMBOLS`` the gather stays on the
    gathering thread, at any pool size and depth, and rebuilds what the
    fanned-out gather does."""
    seen = set()

    def drain_threads():
        store, sched = build(io_workers=4, pipeline_depth=2)
        read = store._read_share_verified
        seen.clear()

        def spy(*a, **k):
            seen.add(threading.get_ident())
            time.sleep(0.002)
            return read(*a, **k)

        store._read_share_verified = spy
        with store:
            rep = sched.drain()
            assert rep.repaired_shares == TASKS
            return len(seen), shares(store), report(rep)

    fanned = drain_threads()
    monkeypatch.setattr(object_store, "GATHER_FAN_OUT_MIN_SYMBOLS", S + 1)
    serial = drain_threads()
    assert fanned[0] > 1 and serial[0] == 1
    assert fanned[1:] == serial[1:]


@pytest.mark.parametrize("workers", [2, 4])
def test_rotten_helper_met_by_another_thread_requeues_the_tick(workers):
    """A helper rotted in storage (no injector) in the window's second
    task, which another thread must take while the first task's thread
    waits: the tick raises nothing, rebuilds nothing and requeues every
    task, as the reference's does, and every staging buffer is back."""
    met = threading.Event()
    where = {}

    def rot(pkg):
        store, sched = build(pkg, io_workers=workers, pipeline_depth=2)
        repair = store.repair_stripes_embedded

        def rotting(tasks):
            (k0, t0, _), (k1, t1, n1) = tasks[0], tasks[1]
            pl = store.placement_of(k1, t1)
            helper = pl[store.code.repair_plan(n1).next_nodes[2] - 1]
            store._shares[helper - 1][(k1, t1)][1][0] ^= 0x55
            if pkg == "port":
                read = store._read_share_verified

                def spy(phys, key, t, *a, **kw):
                    if (key, t) == (k1, t1):
                        where["rotten"] = threading.get_ident()
                        met.set()
                    elif (key, t) == (k0, t0):
                        where["first"] = threading.get_ident()
                        met.wait(DEADLINE_S)
                    return read(phys, key, t, *a, **kw)

                store._read_share_verified = spy
            return repair(tasks)

        store.repair_stripes_embedded = rotting
        with store:
            held = in_use(store)
            rep = sched.drain()
            out = (report(rep), sched.peek_order(), shares(store))
            assert in_use(store) == held
        return out

    got, want = rot("port"), rot("ref")
    assert met.is_set() and where["rotten"] != where["first"]
    assert got == want
    assert got[0]["repaired_shares"] == 0 and got[0]["remaining"] == TASKS


@pytest.mark.parametrize("tile", [64, 2])
def test_rotten_helper_raises_the_serial_gather_s_error(tile):
    """``repair_stripes_embedded`` itself raises the error of the first
    task in window order, with the type and message of the serial
    gather's, whichever thread met it first.  In windows of 2 the error
    comes in the second window, with the first launched and the third
    gathered ahead: every operand goes back to the pool all the same."""
    def first_error(**kw):
        store, sched = build(repair_tile_tasks=tile, **kw)
        with store:
            tasks = [(key, t, store.lost_code_nodes(key, t)[0])
                     for key, t, _ in sched.peek_order()]
            for key, t, node in tasks[3:]:       # rot tasks 3.. in storage
                pl = store.placement_of(key, t)
                helper = pl[store.code.repair_plan(node).prev_node - 1]
                store._shares[helper - 1][(key, t)][2][1] ^= 0x11
            held = in_use(store)
            with pytest.raises(ShareIntegrityError) as err:
                store.repair_stripes_embedded(tasks)
            assert in_use(store) == held
            return type(err.value), str(err.value)

    serial = first_error(io_workers=1, pipeline_depth=1)
    for _ in range(3):
        assert first_error(io_workers=4, pipeline_depth=2) == serial


@pytest.mark.parametrize("workers", [1, 2])
def test_several_windows_in_one_tick_never_deadlock(workers):
    """Windows of one task, prefetched two at a time onto a pool of one
    or two threads that each fan out: the tick completes in time."""
    store, sched = build(io_workers=workers, pipeline_depth=2,
                         repair_tile_tasks=1)
    out = {}

    def tick():
        out["rep"] = sched.drain()

    with store:
        th = threading.Thread(target=tick, daemon=True)
        th.start()
        th.join(DEADLINE_S)
        assert not th.is_alive(), "the drain tick did not complete"
    assert out["rep"].batch_calls == out["rep"].repaired_shares == TASKS


# ----------------------------------------------------------- fan_out alone
def test_fan_out_runs_each_task_once_under_contention():
    """More pool threads than cores, a short switch interval: every index
    runs exactly once, its result lands at its index, and each task's
    sum handed back by ``tallied(..., record=False)`` adds up to every
    call, with nothing recorded on the way."""
    pipe = Pipeline(io_workers=16, depth=2)
    runs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for n in (1, 7, 500):
            runs.clear()
            staging.reset_stage_times()

            def task(i):
                with staging.tallied("x", record=False) as acc:
                    with staging.staged("x"):
                        runs.append(i)
                    with staging.staged("x"):
                        pass
                return 2 * i, acc[1]

            assert pipe.fan_out(n, task, helpers=15) == \
                [(2 * i, 2) for i in range(n)]
            assert sorted(runs) == list(range(n))
            assert staging.stage_calls() == {}
    finally:
        sys.setswitchinterval(interval)
        pipe.close()


def test_fan_out_raises_the_lowest_failing_index():
    pipe = Pipeline(io_workers=4, depth=2)
    try:
        for bad in ([5], [5, 9], [9, 5, 30], [0]):
            def task(i):
                time.sleep(0.001)
                if i in bad:
                    raise KeyError(f"task {i}")
                return i

            with pytest.raises(KeyError) as err:
                pipe.fan_out(40, task, helpers=3)
            assert err.value.args == (f"task {min(bad)}",)

        # task 3 fails first, while task 1 waits for it; then task 1 fails
        third_failed = threading.Event()

        def late(i):
            if i == 1:
                assert third_failed.wait(DEADLINE_S)
                time.sleep(0.05)
                raise KeyError("task 1")
            if i == 3:
                third_failed.set()
                raise KeyError("task 3")
            return i

        with pytest.raises(KeyError) as err:
            pipe.fan_out(8, late, helpers=3)
        assert err.value.args == ("task 1",)
    finally:
        pipe.close()


def test_fan_out_completes_with_no_pool_thread_free():
    """The only pool thread is held by another task until the fan-out has
    returned: the calling thread runs every task itself."""
    pipe = Pipeline(io_workers=1, depth=2)
    gate = threading.Event()
    try:
        blocker = pipe.submit(gate.wait, DEADLINE_S)
        caller = threading.get_ident()
        ran = []
        assert pipe.fan_out(
            6, lambda i: ran.append(threading.get_ident()) or i,
            helpers=3) == list(range(6))
        assert set(ran) == {caller}
    finally:
        gate.set()
        pipe.close()
    assert blocker.result() is True
