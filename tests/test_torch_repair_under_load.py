"""A lost node rebuilt through the read front end's ``tick`` while reads
and updates run between the ticks (the port's repair-under-load path),
held to the plain reference of the benchmark (``perfbench/reference.py``):
every read equals the payload its key held when it was served, every
share after the drain equals the reference's encode of its key's latest
payload.  Also the tick's and the pump's stages on the stage clock, the
front end's stripe counters, and the drain's error path when the queue
walk raises (port and reference side by side)."""
import numpy as np
import pytest

import repro.store as rstore
from perfbench import reference, verify
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.core.circulant import CodeSpec
from repro_torch.serve.frontend import ReadFrontEnd
from repro_torch.store import CodedObjectStore, DrainReport, RepairScheduler

C = [195, 101, 85, 228, 68, 59, 183, 160]
CODE = {"k": 8, "p": 257, "c": C}
S = 256
TASK = 9 * S                    # a regeneration's symbols (d = k + 1)
KEYS = [f"obj{i}" for i in range(6)]


def payload(seed: int, stripes: int = 3) -> bytes:
    gen = np.random.default_rng(seed)
    return gen.integers(0, 256, stripes * 16 * S + 100, np.uint8).tobytes()


def build(depth: int):
    store = CodedObjectStore(CodeSpec.make(8, 257, c=C), n_nodes=20,
                             stripe_symbols=S, pipeline_depth=depth,
                             device="cpu")
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    fe = ReadFrontEnd(store, scheduler=sched)
    ledger = verify.Ledger(16, S, store.placement_of)
    for i, key in enumerate(KEYS):
        data = payload(i)
        store.put(key, data)
        ledger.put(key, data, 0)
    return store, sched, fe, ledger


def queued_keys(sched) -> set:
    return {key for key, _t in sched._queued}


@pytest.mark.parametrize("depth", [1, 2])
def test_tick_drains_a_node_under_reads_and_an_update(depth):
    store, sched, fe, ledger = build(depth)
    node = 5
    lost = ledger.shares_on(node)
    store.fail_node(node)
    store.replace_node(node)
    served, ticks, version = [], [], 0
    with store, fe:
        store.pipeline.reset_stage_stats()
        while sched.pending():
            # two reads of keys whose stripes wait for repair, then a tick
            want = {}
            for key in sorted(queued_keys(sched) or KEYS)[:2]:
                want[key] = ledger.objs[key].payload
                served.append((fe.submit(key), want[key]))
            out = fe.tick(repair_budget_symbols=3 * TASK)
            rep = fe.last_drain
            assert isinstance(rep, DrainReport)
            assert out["repaired_stripes"] == rep.repaired_stripes <= 3
            ticks.append(rep)
            # an update to a key whose stripes are still queued: its put
            # writes every share, and its queued stripes leave the queue
            hot = sorted(queued_keys(sched))
            if hot and version == 0:
                version += 1
                store.put(hot[0], payload(100))
                ledger.put(hot[0], payload(100), version)
                assert hot[0] not in queued_keys(sched)
                assert not any(store.lost_code_nodes(hot[0], t)
                               for t in range(ledger.objs[hot[0]].stripes))
        st = store.pipeline.stage_stats()
        assert fe.tick(repair_budget_symbols=3 * TASK)["repaired_stripes"] \
            == 0 and fe.last_drain is None
    assert len(ticks) > 3 and version == 1
    for tk, want in served:
        assert tk.done and tk.error is None and tk.obj == want
    repaired = sum(r.repaired_shares for r in ticks)
    assert 0 < repaired < len(lost)          # the update re-wrote the rest
    assert all(r.batch_calls == 1 for r in ticks if r.repaired_shares)
    out = verify.check_store(store, ledger, CODE, lost=set(),
                             rebuilt={node}, device="cpu")
    assert out["shares_checked"] == sum(16 * o.stripes
                                        for o in ledger.objs.values())
    assert out["share_mismatch"] == out["share_missing"] == \
        out["placement_bad"] == 0
    for name in ("t_tick_pump", "t_tick_drain", "t_fe_fetch", "t_fe_decode"):
        assert st[name] > 0.0, name
    assert st["t_tick_pump"] >= st["t_fe_fetch"] + st["t_fe_decode"]
    m = fe.metrics
    assert m.coalesced_requests == 0
    assert m.stripes_read == sum(reference.n_stripes(len(want), 16, S)
                                 for _tk, want in served)
    assert 0 < m.degraded_stripes <= m.stripes_read
    assert "stripes_read" not in m.summary()     # the reference's summary


def test_pump_and_drain_share_the_pipeline_and_return_every_buffer():
    store, sched, fe, ledger = build(2)
    pool = store.code.planner.staging
    store.fail_node(9)
    store.replace_node(9)
    before = pool.stats().in_use
    with store, fe:
        while sched.pending():
            for key in KEYS[:3]:
                fe.submit(key)
            fe.tick(repair_budget_symbols=4 * TASK)
            assert pool.stats().in_use == before
            store.put(KEYS[4], payload(200))
            ledger.put(KEYS[4], payload(200), 1)
            assert pool.stats().in_use == before
        assert fe.metrics.decode_dispatches > 0
    out = verify.check_store(store, ledger, CODE, lost=set(), rebuilt={9},
                             device="cpu")
    assert out["share_mismatch"] == out["share_missing"] == 0


def test_stage_clock_records_a_pump_once_a_key_and_a_tick_once():
    from repro_torch.exec import staging
    store, sched, fe, _ledger = build(2)
    store.fail_node(2)
    store.replace_node(2)
    with store, fe:
        for key in KEYS[:3]:
            fe.submit(key)
        staging.reset_stage_times()
        fe.tick(repair_budget_symbols=2 * TASK)
        calls = staging.stage_calls()
    assert calls["tick_pump"] == calls["tick_drain"] == 1
    assert calls["fe_fetch"] == 3              # one record a key
    assert calls["fe_decode"] == 1


def test_ceph_s_stripe_unit_gathers_on_one_thread():
    """The store's own bound keeps a drain at Ceph's 4 KiB unit, and at
    these tests' smaller one, on one gathering thread a window."""
    import threading
    import time
    from repro_torch.store import object_store
    assert object_store.GATHER_FAN_OUT_MIN_SYMBOLS > 4096
    store, sched, _fe, _ledger = build(2)
    seen = set()
    read = store._read_share_verified

    def spy(*a, **k):
        seen.add(threading.get_ident())
        time.sleep(0.001)           # long enough for a helper to start
        return read(*a, **k)

    store._read_share_verified = spy
    store.fail_node(6)
    store.replace_node(6)
    with store:
        assert sched.drain().repaired_shares > 0
    assert len(seen) == 1       # the window's gathering thread alone


def _raising_walk(store, fail_on: int):
    """``lost_code_nodes`` that raises a RuntimeError on its
    ``fail_on``-th call (a store fault in the queue walk)."""
    orig = store.lost_code_nodes
    calls = [0]

    def lost_code_nodes(key, t):
        calls[0] += 1
        if calls[0] == fail_on:
            raise RuntimeError("store fault in the walk")
        return orig(key, t)
    return lost_code_nodes


def _lose(pkg_store, spec, node, **kw):
    """A store of the package with ``node`` lost and replaced, and a
    scheduler that found its stripes by a scan: one heap entry a stripe,
    and no ``up`` event left to enqueue them again."""
    store = pkg_store.CodedObjectStore(spec, n_nodes=20, stripe_symbols=S,
                                       **kw)
    for i, key in enumerate(KEYS[:2]):
        store.put(key, payload(i))
    store.fail_node(node)
    store.replace_node(node)
    sched = pkg_store.RepairScheduler(store)
    store.subscribe(sched.on_event)
    sched.enqueue_scan()
    return store, sched


def test_a_walk_that_raises_after_a_pop_requeues_what_it_popped():
    """The port walks the queue inside the tick's ``try`` (its stage
    ``select``): the stripe the walk popped before the fault goes back on
    the heap at its priority, so the queue holds every stripe and a later
    drain rebuilds them all.  The reference walks before its ``try``: the
    popped stripe stays in ``_queued`` with no heap entry, stranded until
    something enqueues it again."""
    import repro_torch.store as tstore
    port, psched = _lose(tstore, CodeSpec.make(8, 257, c=C), 4,
                         device="cpu")
    ref, rsched = _lose(rstore, RSpec.make(8, 257, c=C), 4)
    queued = set(psched._queued)
    assert queued == set(rsched._queued) and len(queued) > 2
    first = psched.peek_order()[0][:2]
    assert first == rsched.peek_order()[0][:2]
    for store, sched in ((port, psched), (ref, rsched)):
        store.lost_code_nodes = _raising_walk(store, 2)
        with pytest.raises(RuntimeError, match="store fault in the walk"):
            sched.drain()
        del store.lost_code_nodes               # the fault has passed
    # port: every stripe queued and on the heap, the popped one pushed
    # again at its priority (remaining redundancy 7 after one loss)
    assert set(psched._queued) == queued
    on_heap = {(key, t) for _rem, _seq, key, t in psched._heap}
    assert on_heap == queued
    assert [e for e in psched.peek_order() if e[:2] == first] == \
        [first + (7,)]
    assert psched.pending() == len(queued)
    rep = psched.drain_all()
    assert rep.repaired_shares == len(queued) and psched.pending() == 0
    assert port.verify() is True
    # reference: the popped stripe is still counted but on no heap entry
    assert set(rsched._queued) == queued
    on_heap = {(key, t) for _rem, _seq, key, t in rsched._heap}
    assert on_heap == queued - {first}
    with pytest.raises(RuntimeError, match="repair stalled"):
        rsched.drain_all()
    assert set(rsched._queued) == {first} and not rsched._heap
