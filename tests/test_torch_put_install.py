"""The put's install (`CodedObjectStore.put`): each window's shares are
views of its encode result and of the payload blocks, where they lie, and
their CRCs are shared out over the store's pool (`Pipeline.fan_out`) at
depth > 1 with no fault injector and stripe units of
``GATHER_FAN_OUT_MIN_SYMBOLS`` (2^16) or more.

Held here, on the CPU at reduced sizes (k = 2 and 4; S = 4096 and 2^16):
every stored block is C-contiguous and every derived block shares memory
with exactly its window's encode result; shares, CRC ledgers, placement
and receipts equal the reference's for the double-circulant and the
product-matrix classes, with and without a FAILED node (lost-at-birth
shares); the fanned-out install equals the serial one share for share,
in the order shares are placed; below the bound and under a fault
injector the checks run serially, and a give-up leaves the store as it
was; and the stage ``t_install`` is recorded once a window and covers
``t_crc``."""
import os
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

import repro.codes as rcodes
import repro.store as rstore
import repro_torch.codes as tcodes
import repro_torch.io as tio
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.codes.double_circulant import DoubleCirculantCode
from repro_torch.codes.product_matrix import ProductMatrixMSR
from repro_torch.core.circulant import CodeSpec as TSpec
from repro_torch.exec import staging
from repro_torch.exec.pipeline import Pipeline
from repro_torch.io.retry import GiveUpError
from repro_torch.store import CodedObjectStore
from repro_torch.store import object_store

BIG, SMALL = 1 << 16, 1 << 12
PM = {2: ("product-matrix", 4, 2, 3), 4: ("product-matrix", 8, 4, 6)}
TILE = 2            # stripes a put window: objects span several windows
LOST = 2            # the node FAILED during a put


def blob(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def objects(k, s):
    """Three objects of 5, 1 and 3 stripes at 2k data blocks of S."""
    stripe = 2 * k * s
    return [("a", blob(4 * stripe + 77, 1)), ("b", blob(100, 2)),
            ("c", blob(3 * stripe, 3))]


def make(pkg, k, s, **kw):
    if pkg == "port":
        return CodedObjectStore(TSpec.make(k, 257), n_nodes=2 * k + 2,
                                stripe_symbols=s, put_tile_stripes=TILE,
                                device="cpu", **kw)
    return rstore.CodedObjectStore(RSpec.make(k, 257), n_nodes=2 * k + 2,
                                   stripe_symbols=s, put_tile_stripes=TILE,
                                   **kw)


def filled(pkg, k, s, family=None, lost=False, **kw):
    """A store holding `objects` (the first of class ``family``), put
    with node LOST FAILED when ``lost``."""
    store = make(pkg, k, s, **kw)
    codes = tcodes if pkg == "port" else rcodes
    if lost:
        store.fail_node(LOST)
    for i, (key, data) in enumerate(objects(k, s)):
        cc = codes.CodeClass(*family) if family and i == 0 else None
        assert store.put(key, data, code_class=cc).n_stripes >= 1
    return store


def shares(store):
    """Every node's shares in the order they were placed, as bytes."""
    return [[(kt, s[0]) + tuple(np.asarray(b, np.int32).tobytes()
                                for b in s[1:])
             for kt, s in held.items()] for held in store._shares]


def ledgers(store):
    """What a put leaves beside its shares: each object's CRC ledger,
    geometry and placement, the receipts and the lost shares."""
    out = {}
    for key in store.keys():
        st = store.stat(key)
        out[key] = (st.size_bytes, st.n_stripes, st.stripe_symbols,
                    st.share_crcs, st.meta["_base_stripe"],
                    [store.placement_of(key, t)
                     for t in range(st.n_stripes)])
    return out, store.metrics.summary(), store.total_lost_shares()


@pytest.fixture
def encodes(monkeypatch):
    """Every put window's encode result, by code family, as the port's
    put takes it from ``PlanResult.host()``."""
    seen = []
    for cls in (DoubleCirculantCode, ProductMatrixMSR):
        orig = cls.encode_derived_planned

        def spy(self, flat, _orig=orig):
            res = _orig(self, flat)
            seen.append(res)
            return res

        monkeypatch.setattr(cls, "encode_derived_planned", spy)
    return seen


@pytest.mark.parametrize("family", [False, True])
@pytest.mark.parametrize("k,s", [(2, BIG), (4, SMALL)])
def test_stored_blocks_are_views_of_the_window_s_encode(k, s, family,
                                                        encodes):
    store = filled("port", k, s, PM[k] if family else None)
    with store:
        # one result a window of TILE stripes, in put order
        first, windows = {}, 0
        for key, _data in objects(k, s):
            first[key] = windows
            windows += -(-store.stat(key).n_stripes // TILE)
        results = [np.asarray(r.host()) for r in encodes]
        assert len(results) == windows
        derived = {}
        for held in store._shares:
            for (key, t), share in held.items():
                own = results[first[key] + t // TILE]
                blks = share[1:]
                assert len(blks) == store.codec_of(key).code.share_blocks
                for b in blks:
                    assert b.dtype == np.int32 and b.shape == (s,)
                    assert b.flags.c_contiguous
                    # a derived block lies in its own window's result
                    # and in no other; a payload block in none
                    hits = [np.shares_memory(b, r) for r in results]
                    assert sum(hits) <= 1
                    if any(hits):
                        assert np.shares_memory(b, own)
                derived[key, t] = derived.get((key, t), 0) + sum(
                    np.shares_memory(b, own) for b in blks)
        # every derived row of every stripe is stored as a view
        for (key, _t), count in derived.items():
            assert count == store.codec_of(key).code.derived_rows


@pytest.mark.parametrize("lost", [False, True])
@pytest.mark.parametrize("family", [False, True])
@pytest.mark.parametrize("k,s", [(2, BIG), (2, SMALL), (4, BIG),
                                 (4, SMALL)])
def test_shares_and_ledgers_equal_the_reference(k, s, family, lost):
    fam = PM[k] if family else None
    port = filled("port", k, s, fam, lost, pipeline_depth=2)
    ref = filled("ref", k, s, fam, lost)
    with port:
        got = shares(port), ledgers(port)
    want = shares(ref), ledgers(ref)
    # windows of one put may install side by side at depth 2, so each
    # node's shares are compared as a set (the placed order is held in
    # test_fanned_out_install_equals_the_serial_one)
    assert [sorted(h) for h in got[0]] == [sorted(h) for h in want[0]]
    assert got[1] == want[1]
    assert (port.total_lost_shares() > 0) == lost


class FanOutSpy:
    """Records each `Pipeline.fan_out` call's ``helpers`` and the set of
    threads that ran its tasks."""

    def __init__(self, monkeypatch):
        self.helpers, self.threads = [], []
        orig = Pipeline.fan_out
        spy = self

        def fan_out(pipe, n, task, *, helpers=0, **kw):
            ran = set()
            spy.helpers.append(helpers)
            spy.threads.append(ran)

            def traced(i):
                ran.add(threading.get_ident())
                return task(i)
            return orig(pipe, n, traced, helpers=helpers, **kw)

        monkeypatch.setattr(Pipeline, "fan_out", fan_out)


@pytest.mark.parametrize("family", [False, True])
@pytest.mark.parametrize("workers", [2, 4])
def test_fanned_out_install_equals_the_serial_one(workers, family,
                                                  monkeypatch):
    fam = PM[2] if family else None
    # one window a put (no TILE): the placed order is then deterministic
    serial = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                              stripe_symbols=BIG, pipeline_depth=1,
                              device="cpu")
    spy = FanOutSpy(monkeypatch)
    fanned = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                              stripe_symbols=BIG, pipeline_depth=2,
                              io_workers=workers, device="cpu")
    for store in (serial, fanned):
        with store:
            store.fail_node(LOST)
            for i, (key, data) in enumerate(objects(2, BIG)):
                cc = tcodes.CodeClass(*fam) if fam and i == 0 else None
                store.put(key, data, code_class=cc)
            assert store.get("a") == objects(2, BIG)[0][1]
    assert shares(fanned) == shares(serial)     # placed order included
    assert ledgers(fanned) == ledgers(serial)
    # the serial store's three puts fanned out to no one, the others' to
    # io_workers - 1 pool threads each
    assert spy.helpers == [0] * 3 + [workers - 1] * 3


@pytest.mark.parametrize("faults", [False, True])
def test_small_units_and_a_fault_injector_check_serially(faults,
                                                         monkeypatch):
    s = SMALL if not faults else BIG
    kw = {}
    if faults:
        inj = tio.FaultInjector(seed=3, sleep=lambda _s: None)
        inj.add(op="write", match="node:04", kind="transient", times=1)
        kw = {"faults": inj, "retry": tio.fast_retry(max_attempts=2)}
    spy = FanOutSpy(monkeypatch)
    store = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                             stripe_symbols=s, pipeline_depth=2,
                             io_workers=4, device="cpu", **kw)
    with store:
        for key, data in objects(2, s):
            store.put(key, data)
        assert store.get("c") == objects(2, s)[2][1]
        assert store._fan_out_helpers() == 0
    # each put's checks ran on the one thread that ran its install
    assert spy.helpers == [0, 0, 0]
    assert [len(ran) for ran in spy.threads] == [1, 1, 1]
    assert not faults or inj.fired_total == 1


@pytest.mark.parametrize("s", [SMALL, BIG])
def test_a_give_up_leaves_the_store_as_it_was(s):
    inj = tio.FaultInjector(seed=3, sleep=lambda _s: None)
    store = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                             stripe_symbols=s, pipeline_depth=2,
                             put_tile_stripes=TILE, faults=inj,
                             retry=tio.fast_retry(max_attempts=2),
                             device="cpu")
    key, data = objects(2, s)[0]
    with store:
        store.put(key, data)
        before = shares(store), ledgers(store)
        inj.add(op="write", match="node:05", kind="transient")
        with pytest.raises(GiveUpError):
            store.put(key, blob(len(data), 9))      # an overwrite
        with pytest.raises(GiveUpError):
            store.put("new", data)
        assert shares(store) == before[0] and ledgers(store) == before[1]
        inj.clear()
        assert store.get(key) == data and "new" not in store.keys()


@pytest.mark.parametrize("s", [SMALL, BIG])
def test_install_stage_is_recorded_once_a_window(s):
    store = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                             stripe_symbols=s, pipeline_depth=2,
                             put_tile_stripes=TILE, device="cpu")
    key, data = objects(2, s)[0]                # 5 stripes, 3 windows
    with store:
        store.put(key, data)
        staging.reset_stage_times()
        store.pipeline.reset_stage_stats()
        store.put(key, data)
        calls, times = staging.stage_calls(), staging.stage_times()
        st = store.pipeline.stage_stats()
    assert calls["install"] == calls["crc"] == 3
    assert times["install"] >= times["crc"] > 0.0
    assert st["t_install"] == pytest.approx(times["install"])
    assert st["t_install"] >= st["t_crc"] > 0.0


def test_fan_out_rule_is_the_gather_s(monkeypatch):
    """One rule for the gather and the install: the bound is
    ``GATHER_FAN_OUT_MIN_SYMBOLS`` as the module holds it."""
    store = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                             stripe_symbols=SMALL, pipeline_depth=2,
                             io_workers=4, device="cpu")
    with store:
        assert store._fan_out_helpers() == 0
        monkeypatch.setattr(object_store, "GATHER_FAN_OUT_MIN_SYMBOLS",
                            SMALL)
        assert store._fan_out_helpers() == 3
        store.pipeline.depth = 1
        assert store._fan_out_helpers() == 0


@pytest.mark.parametrize("s", [SMALL, BIG])
def test_a_failed_check_places_nothing(s, monkeypatch):
    store = CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                             stripe_symbols=s, pipeline_depth=2,
                             put_tile_stripes=TILE, device="cpu")
    key, data = objects(2, s)[0]
    orig = DoubleCirculantCode.share_crc_blocks
    checks = []

    def flaky(self, blocks):
        checks.append(1)
        if len(checks) > 3:
            raise ValueError("check failed")
        return orig(self, blocks)

    with store:
        store.put(key, data)
        before = shares(store), ledgers(store)
        held = store.code.planner.staging.stats().in_use
        monkeypatch.setattr(DoubleCirculantCode, "share_crc_blocks", flaky)
        with pytest.raises(ValueError, match="check failed"):
            store.put(key, blob(len(data), 9))
        assert shares(store) == before[0] and ledgers(store) == before[1]
        assert store.code.planner.staging.stats().in_use == held
        monkeypatch.setattr(DoubleCirculantCode, "share_crc_blocks", orig)
        store.put("b", data)
        assert store.get(key) == data and store.get("b") == data


def test_many_threads_fill_every_ledger_slot(monkeypatch):
    """More pool threads than cores and a short switch interval: every
    share's CRC lands in its own slot and every share is placed, as the
    serial install does, and the put completes in time."""
    monkeypatch.setattr(object_store, "GATHER_FAN_OUT_MIN_SYMBOLS", SMALL)
    workers = (os.cpu_count() or 1) + 4
    data = blob(6 * 4 * SMALL, 5)                  # 6 stripes, one window
    stores = [CodedObjectStore(TSpec.make(2, 257), n_nodes=6,
                               stripe_symbols=SMALL, pipeline_depth=depth,
                               io_workers=workers, device="cpu")
              for depth in (1, 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for store in stores:
            with store:
                for rep in range(3):
                    th = threading.Thread(
                        target=store.put, args=(f"o{rep}", data),
                        daemon=True)
                    th.start()
                    th.join(60.0)
                    assert not th.is_alive(), "the put did not complete"
    finally:
        sys.setswitchinterval(interval)
    serial, fanned = stores
    assert fanned._fan_out_helpers() == workers - 1
    assert shares(fanned) == shares(serial)
    assert ledgers(fanned) == ledgers(serial)
    assert all(c for crcs in (fanned.stat(k).share_crcs
                              for k in fanned.keys()) for row in crcs
               for c in row)


def test_fan_out_enters_around_once_a_thread_and_waits_for_its_exit():
    """``around`` wraps each taking-part thread's run of tasks once, and
    the call returns only after every thread has left it (a slow exit
    included); an error raised by ``around`` itself reaches the caller."""
    pipe = Pipeline(io_workers=8, depth=2)
    entered, left = [], []

    @contextmanager
    def around():
        entered.append(threading.get_ident())
        yield
        time.sleep(0.01)
        left.append(threading.get_ident())

    try:
        for n in (1, 5, 200):
            entered.clear()
            left.clear()
            ran = set()

            def task(i):
                ran.add(threading.get_ident())
                time.sleep(0.0005)
                return 3 * i

            assert pipe.fan_out(n, task, helpers=7, around=around) == \
                [3 * i for i in range(n)]
            assert len(set(entered)) == len(entered) and ran <= set(entered)
            assert sorted(left) == sorted(entered)

        @contextmanager
        def broken():
            raise KeyError("around")
            yield

        with pytest.raises(KeyError):
            pipe.fan_out(4, lambda i: i, helpers=3, around=broken)
    finally:
        pipe.close()
