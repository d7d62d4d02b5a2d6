"""Port parity — the robust serving front end (mirrors tests/test_serve.py).

Every twin runs the SAME script through a front end of each package, in
front of a store of that package (the port's on the CPU), with the same
FakeClock, and holds the port to the reference exactly: the tickets with
their receipts and typed errors, ``metrics.summary()``, the quarantine
event log, each node's health ledger and the store's shares.  The hedging
twins depend on real fetch latency, so they run the reference test's
checks on each package without comparing the two.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_parity import no_cuda  # noqa: F401 (fixture)

import repro.io as rio
import repro.serve as rserve
import repro.store as rstore
import repro.train.fault_tolerance as rft
import repro_torch.io as tio
import repro_torch.serve as tserve
import repro_torch.store as tstore
import repro_torch.train.fault_tolerance as tft
from repro.core.circulant import CodeSpec as RSpec
from repro_torch.core.circulant import CodeSpec as TSpec

PORT = SimpleNamespace(name="port", CodeSpec=TSpec, store=tstore, io=tio,
                       serve=tserve, ft=tft, kw={"device": "cpu"})
REF = SimpleNamespace(name="ref", CodeSpec=RSpec, store=rstore, io=rio,
                      serve=rserve, ft=rft, kw={})


class FakeClock:
    """Deterministic clock: advances a fixed step per call."""

    def __init__(self, step=0.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def payload_bytes(size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def norm(x):
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, BaseException):
        return ("exc", type(x).__name__, str(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((repr(k), norm(v))
                                     for k, v in x.items())))
    if isinstance(x, (list, tuple, set)):
        return tuple(norm(v) for v in (sorted(x) if isinstance(x, set)
                                       else x))
    return x


class Twin:
    """A store and a front end per package, built alike (same FakeClock
    step, same fault rules); ``run`` applies a script to both and asserts
    equal results and equal front-end and store state."""

    def __init__(self, *, k=2, n_nodes=6, stripe_symbols=64, clock_step=0.0,
                 faults=None, sched=False, compare=True, **fe_kw):
        self.sides = []
        self.compare = compare
        for pkg in (PORT, REF):
            kw = dict(pkg.kw)
            if faults is not None:
                inj = pkg.io.FaultInjector(seed=0)
                for rule in faults:
                    inj.add(**rule)
                kw.update(faults=inj, retry=pkg.io.fast_retry())
            st = pkg.store.CodedObjectStore(
                pkg.CodeSpec.make(k, 257), n_nodes=n_nodes,
                stripe_symbols=stripe_symbols, **kw)
            sc = None
            if sched:
                sc = pkg.store.RepairScheduler(st)
                st.subscribe(sc.on_event)
            fe = pkg.serve.ReadFrontEnd(st, scheduler=sc,
                                        clock=FakeClock(clock_step), **fe_kw)
            self.sides.append(SimpleNamespace(pkg=pkg, store=st, sched=sc,
                                              fe=fe))

    def state(self, s):
        health = {p: dataclasses.asdict(h) for p, h in s.fe._health.items()}
        return norm({"summary": s.fe.metrics.summary(),
                     "events": s.fe.events,
                     "health": health,
                     "quarantined": s.fe.quarantined_nodes(),
                     "shares": [{kt: [v[0], v[1], v[2]]
                                 for kt, v in held.items()}
                                for held in s.store._shares],
                     "pending": None if s.sched is None
                     else s.sched.pending()})

    def run(self, script, raises=False):
        """``raises``: the script is expected to raise (on both sides)."""
        outs = []
        for s in self.sides:
            try:
                out = script(s)
            except Exception as e:                  # noqa: BLE001
                if not raises:
                    raise
                out = e
            outs.append((norm(out), self.state(s)))
        if self.compare:
            assert outs[0] == outs[1]
        return outs[0][0]

    def close(self):
        for s in self.sides:
            s.fe.close()
            s.store.close()


def tickets(*tks):
    return [(tk.uid, tk.key, tk.priority, tk.done, tk.obj, tk.error,
             tk.receipt) for tk in tks]


# ---------------------------------------------------------- ticket lifecycle
class TestTickets:
    def test_submit_pump_result(self):
        tw = Twin()
        data = payload_bytes(300)

        def script(s):
            s.store.put("a", data)
            tk = s.fe.submit("a")
            with pytest.raises(RuntimeError, match="not.*served"):
                tk.result()
            s.fe.pump()
            assert tk.result() == data
            return tickets(tk)

        tw.run(script)
        tw.close()

    def test_read_convenience_and_coalescing_per_key(self):
        tw = Twin(clock_step=0.001)
        data = payload_bytes(500, seed=1)

        def script(s):
            s.store.put("a", data)
            t1, t2 = s.fe.submit("a"), s.fe.submit("a")
            s.fe.pump()
            return tickets(t1, t2), s.fe.read("a")

        out = tw.run(script)
        assert out[1] == data
        tw.close()

    def test_unknown_key_is_typed(self):
        tw = Twin()
        out = tw.run(lambda s: s.fe.read("nope"), raises=True)
        assert out[:2] == ("exc", "UnknownKeyError")
        tw.close()

    def test_deadline_miss_is_accounted(self):
        tw = Twin(clock_step=0.05)

        def script(s):
            s.store.put("a", payload_bytes(128, seed=2))
            tk = s.fe.read_ext("a", deadline_s=0.01)
            assert tk.error is None and not tk.receipt.deadline_met
            return tickets(tk)

        tw.run(script)
        tw.close()

    def test_priority_order_within_pump(self):
        tw = Twin()

        def script(s):
            for key in ("lo", "hi"):
                s.store.put(key, payload_bytes(64, seed=3))
            a = s.fe.submit("lo", priority=0)
            b = s.fe.submit("hi", priority=5)
            return [tk.key for tk in s.fe.pump()], tickets(a, b)

        assert tw.run(script)[0] == ("hi", "lo")
        tw.close()


# -------------------------------------------------- deadline budget plumbing
class TestDeadlineBudget:
    def test_retry_budget_caps_wall_but_first_attempt_runs(self):
        calls = []

        def boom():
            calls.append(1)
            raise OSError("transient")

        with pytest.raises(tio.GiveUpError) as ei:
            tio.fast_retry(max_attempts=5).call(boom, op="x", budget_s=0.0)
        assert ei.value.attempts == 1 and len(calls) == 1

    def test_read_share_budget_zero_still_reads(self):
        tw = Twin()

        def script(s):
            s.store.put("a", payload_bytes(64, seed=4))
            pl = s.store.placement_of("a", 0)
            return s.store.read_share(pl[0], "a", 0, budget_s=0.0)

        assert tw.run(script)[0] == 1
        tw.close()


# ------------------------------------------------------------ CRC integrity
class TestIntegrity:
    def test_storage_rot_decoded_around_dropped_and_enqueued(self):
        tw = Twin(sched=True)
        data = payload_bytes(64, seed=5)

        def script(s):
            s.store.put("obj", data)
            phys = s.store.placement_of("obj", 0)[0]
            s.store._shares[phys - 1][("obj", 0)][1][0] ^= 0x55
            before = s.store.share_intact(phys, "obj", 0)
            tk = s.fe.read_ext("obj")
            after = s.store.share_intact(phys, "obj", 0)
            rep = s.sched.drain_all()
            return (before, tickets(tk), after, rep,
                    s.store.share_intact(phys, "obj", 0))

        out = tw.run(script)
        assert (out[0], out[2], out[4]) == (False, None, True)
        tw.close()

    def test_transient_read_flip_rereads_without_dropping(self):
        tw = Twin(faults=[{"op": "read", "kind": "corrupt", "times": 1}],
                  hedge_after_s=None)

        def script(s):
            s.store.put("obj", payload_bytes(64, seed=6))
            return tickets(s.fe.read_ext("obj")), [
                s.store.share_intact(p, "obj", 0)
                for p in s.store.placement_of("obj", 0)]

        tw.run(script)
        assert [e["what"] for e in tw.sides[0].fe.events] == \
            ["crc_transient"]
        tw.close()

    def test_suspicion_weights_rank_crc_over_hedge(self):
        for pkg in (PORT, REF):
            h = pkg.serve.NodeHealth()
            fe = pkg.serve.ReadFrontEnd(pkg.store.CodedObjectStore(
                pkg.CodeSpec.make(2, 257), **pkg.kw))
            assert fe.crc_weight > fe.giveup_weight > fe.hedge_weight
            h.observe(0.010)
            h.observe(0.020)
            assert h.ewma_read_s == pytest.approx(0.013)
            fe.close()


# ------------------------------------------------- quarantine state machine
class TestQuarantine:
    def test_quarantine_dirty_scrub_then_clean_readmit(self):
        tw = Twin(sched=True, quarantine_threshold=2.0)
        k1, k2 = payload_bytes(64, seed=7), payload_bytes(64, seed=8)

        def script(s):
            s.store.put("k1", k1)
            s.store.put("k2", k2)
            phys = sorted(set(s.store.placement_of("k1", 0))
                          & set(s.store.placement_of("k2", 0)))[0]
            s.store._shares[phys - 1][("k1", 0)][1][0] ^= 0x55
            s.store._shares[phys - 1][("k2", 0)][1][1] ^= 0x55
            got = s.fe.read("k1")
            q = s.fe.quarantined_nodes()
            out1 = s.fe.scrub_quarantined()
            rep = s.sched.drain_all()
            out2 = s.fe.scrub_quarantined()
            return got, q, out1, rep, out2, s.fe.read("k2")

        out = tw.run(script)
        assert out[0] == k1 and out[5] == k2
        kinds = [e["what"] for e in tw.sides[0].fe.events]
        assert kinds.index("quarantine") < kinds.index("scrub_dirty") \
            < kinds.index("readmit")
        tw.close()

    def test_quarantined_node_still_last_resort(self):
        tw = Twin()

        def script(s):
            s.store.put("obj", payload_bytes(64, seed=9))
            pl = s.store.placement_of("obj", 0)
            s.fe.health(pl[0]).quarantined = True
            s.fe.health(pl[1]).quarantined = True
            return tickets(s.fe.read_ext("obj"))

        tw.run(script)
        tw.close()


# ----------------------------------------------------- heartbeat avoidance
class TestHeartbeatAvoidance:
    def test_straggler_and_dead_demoted_before_hedge(self):
        sides = []
        for pkg in (PORT, REF):
            st = pkg.store.CodedObjectStore(pkg.CodeSpec.make(2, 257),
                                            n_nodes=6, stripe_symbols=64,
                                            **pkg.kw)
            st.put("obj", payload_bytes(64, seed=10))
            pl = st.placement_of("obj", 0)
            hb = pkg.ft.HeartbeatMonitor(st.n_nodes, timeout_s=60.0,
                                         straggler_s=5.0)
            for node in range(1, st.n_nodes + 1):
                hb.beat(node, step=10, now=99.0)
            hb.beat(pl[0], step=10, now=90.0)
            hb.declare_dead(pl[1])
            with pkg.serve.ReadFrontEnd(st, heartbeat=hb, clock=FakeClock(),
                                        heartbeat_clock=lambda: 100.0) as fe:
                sides.append(norm((fe._avoid_reasons(),
                                   tickets(fe.read_ext("obj")))))
        assert sides[0] == sides[1]


# ------------------------------------------------------------------ hedging
class TestHedging:
    def test_hedged_read_abandons_straggler_and_learns(self):
        tw = Twin(faults=[], compare=False, hedge_after_s=0.005)

        def script(s):
            data = payload_bytes(64, seed=11)
            s.store.put("obj", data)
            phys = s.store.placement_of("obj", 0)[0]
            s.store.faults.add(op="read", kind="latency",
                               match=f"node:{phys:02d}", latency_s=0.2)
            assert s.fe.read("obj") == data
            assert s.fe.metrics.hedged_fetches >= 1
            assert s.fe.health(phys).timeouts >= 1
            s.fe.close()                  # the straggling fetch lands

        tw.run(script)
        tw.close()

    def test_unhedged_baseline_waits_and_serves(self):
        tw = Twin(faults=[], compare=False, hedge_after_s=None)

        def script(s):
            data = payload_bytes(64, seed=12)
            s.store.put("obj", data)
            phys = s.store.placement_of("obj", 0)[0]
            s.store.faults.add(op="read", kind="latency",
                               match=f"node:{phys:02d}", latency_s=0.02)
            assert s.fe.read("obj") == data
            assert s.fe.metrics.hedged_fetches == 0
            assert s.fe.metrics.degraded_stripes == 0

        tw.run(script)
        tw.close()


# --------------------------------------------------------- admission control
class TestOverload:
    def test_shed_is_typed_low_priority_first(self):
        tw = Twin(max_queue=3)

        def script(s):
            for i in range(2):
                s.store.put(f"k{i}", payload_bytes(64, seed=13 + i))
            low = [s.fe.submit("k0", priority=0) for _ in range(3)]
            hi = s.fe.submit("k1", priority=2)
            extra = s.fe.submit("k0", priority=0)
            shed = [tk.uid for tk in low + [hi, extra]
                    if isinstance(tk.error, (rserve.Overloaded,
                                             tserve.Overloaded))]
            s.fe.pump()
            return shed, tickets(*low, hi, extra)

        assert len(tw.run(script)[0]) == 2
        tw.close()

    def test_equal_priority_newest_loses(self):
        tw = Twin(max_queue=1)

        def script(s):
            s.store.put("k", payload_bytes(64, seed=15))
            first = s.fe.submit("k", priority=1)
            second = s.fe.submit("k", priority=1)
            return tickets(first, second)

        out = tw.run(script)
        assert out[1][5][:2] == ("exc", "Overloaded")
        tw.close()


# ----------------------------------------------- cross-request coalescing
class TestCoalescing:
    def test_one_decode_dispatch_per_pattern_across_keys(self):
        tw = Twin()

        def script(s):
            st = s.store
            st.put("a", payload_bytes(64, seed=16))
            st._next_stripe = st.stat("a").meta["_base_stripe"]
            st.put("b", payload_bytes(64, seed=17))
            st.fail_node(st.placement_of("a", 0)[0])
            t1, t2 = s.fe.submit("a"), s.fe.submit("b")
            s.fe.pump()
            return tickets(t1, t2)

        tw.run(script)
        assert tw.sides[0].fe.metrics.decode_dispatches == 1
        tw.close()

    def test_tick_interleaves_serving_scrub_and_repair(self):
        tw = Twin(sched=True)
        data = payload_bytes(400, seed=18)

        def script(s):
            s.store.put("obj", data)
            s.store.fail_node(1)
            s.fe.submit("obj")
            return s.fe.tick(repair_budget_symbols=10_000_000), \
                s.store.get("obj")

        out = tw.run(script)
        assert out[1] == data
        tw.close()


# ------------------------------------------------------------------ metrics
def test_percentiles_and_summary_shape():
    for pkg in (PORT, REF):
        m = pkg.serve.FrontEndMetrics()
        assert m.latency_percentiles() == {"p50_s": 0.0, "p99_s": 0.0,
                                           "p999_s": 0.0, "max_s": 0.0}
        m.wall_latencies = [float(i) for i in range(1, 101)]
        lat = m.latency_percentiles()
        assert lat["p50_s"] == 50.0 and lat["p99_s"] == 99.0
        assert lat["p999_s"] == 100.0 and lat["max_s"] == 100.0


# --------------------------------------------------- a seeded mixed workload
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_workload_receipts_summary_and_events_equal(seed):
    """Objects of mixed sizes at the production width, a lost node, rot
    on a second node, four priorities over a short queue (reads shed as
    Overloaded), cross-key coalesced decodes, then tick() drains and
    scrubs: every ticket, receipt, the summary and the event log equal."""
    rng = np.random.default_rng(seed)
    objs = {f"o{i}": payload_bytes(int(n), seed=seed * 10 + i)
            for i, n in enumerate(rng.integers(1, 9000, 6))}
    reads = [(f"o{int(rng.integers(0, 6))}", int(rng.integers(0, 4)))
             for _ in range(24)]
    tw = Twin(k=8, n_nodes=20, stripe_symbols=97, clock_step=0.0005,
              sched=True, max_queue=10, quarantine_threshold=2.0)

    def script(s):
        st = s.store
        for key, v in objs.items():
            st.put(key, v)
        st.fail_node(3)
        victim = next(v for v in st.placement_of("o0", 0) if v != 3)
        st._shares[victim - 1][("o0", 0)][1][2] ^= 0x21
        tks = [s.fe.submit(key, priority=pri) for key, pri in reads]
        s.fe.pump()
        for tk in tks:
            if tk.error is None:
                assert tk.obj == objs[tk.key]
        ticks = [s.fe.tick(repair_budget_symbols=50_000) for _ in range(2)]
        ticks.append(s.fe.tick())                 # drains what is left
        return tickets(*tks), ticks, s.fe.scrub_quarantined(), st.verify()

    out = tw.run(script)
    assert out[-1] is True
    summary = tw.sides[0].fe.metrics.summary()
    assert summary["shed"] > 0 and summary["decode_dispatches"] > 0
    assert summary["crc_rejected"] >= 1 and summary["degraded_stripes"] > 0
    tw.close()


def test_front_end_store_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.CodedObjectStore(TSpec.make(2, 257))
    assert torch.cuda.is_available() is False
