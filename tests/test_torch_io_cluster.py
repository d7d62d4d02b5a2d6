"""Port parity — the I/O substrate and the cluster types.

repro_torch.io (LocalBlob, RetryPolicy, FaultInjector, FaultyBlob) and
repro_torch.cluster (events, metrics) against repro.io / repro.cluster:
the same bytes on disk, the same retry schedules and give-ups, the same
seeded fault streams — draw for draw, corrupt bytes and flipped share
symbols included — the same scenarios and the same metric summaries.
"""
import numpy as np
import pytest

from repro import cluster as rcluster
from repro.cluster import events as revents
from repro.cluster import metrics as rmetrics
from repro.core import placement as rplace
from repro.io import blob as rblob
from repro.io import faults as rfaults
from repro.io import retry as rretry
from repro_torch import cluster as tcluster
from repro_torch.cluster import events as tevents
from repro_torch.cluster import metrics as tmetrics
from repro_torch.core import placement as tplace
from repro_torch.io import blob as tblob
from repro_torch.io import faults as tfaults
from repro_torch.io import retry as tretry


# --------------------------------------------------------------------- blob
@pytest.mark.parametrize("mod", [tblob, rblob], ids=["port", "reference"])
def test_local_blob_roundtrip(mod, tmp_path):
    b = mod.LocalBlob(fsync=True)
    b.mkdir(tmp_path / "d")
    b.write(tmp_path / "d" / "x.tmp", b"payload")
    assert b.isdir(tmp_path / "d") and b.exists(tmp_path / "d" / "x.tmp")
    assert mod.count_tmp_orphans(tmp_path) == 1
    b.rename(tmp_path / "d" / "x.tmp", tmp_path / "d" / "x")
    b.fsync_dir(tmp_path / "d")
    assert b.read(tmp_path / "d" / "x") == b"payload"
    assert b.listdir(tmp_path / "d") == ["x"]
    assert mod.count_tmp_orphans(tmp_path) == 0
    b.remove(tmp_path / "d" / "x")
    b.rmtree(tmp_path / "d")
    assert not b.exists(tmp_path / "d")
    assert mod.count_tmp_orphans(tmp_path / "nothing") == 0
    with pytest.raises(NotImplementedError):
        mod.BlobBackend().read("x")


# -------------------------------------------------------------------- retry
def _retry_trace(mod, fail_times, **kw):
    """(value or give-up, attempts, sleeps, stats) of one retried op."""
    sleeps, calls = [], [0]
    clock = [0.0]

    def fn():
        calls[0] += 1
        if calls[0] <= fail_times:
            raise OSError(f"flaky {calls[0]}")
        return "ok"

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    pol = mod.RetryPolicy(sleep=sleep, clock=lambda: clock[0], **kw)
    stats = mod.RetryStats()
    try:
        out = pol.call(fn, op="read:node:03", stats=stats)
    except mod.GiveUpError as e:
        out = ("gave up", e.op, e.attempts, type(e.__cause__).__name__)
    return out, calls[0], sleeps, stats.summary()


@pytest.mark.parametrize("fail_times,kw", [
    (0, {}), (2, {}), (3, {}), (9, {}), (9, {"max_attempts": 7}),
    (9, {"op_timeout_s": 0.05}), (5, {"jitter": 0.0, "multiplier": 3.0}),
    (5, {"max_delay_s": 0.02, "max_attempts": 6})])
def test_retry_schedule_identical(fail_times, kw):
    assert _retry_trace(tretry, fail_times, **kw) == \
        _retry_trace(rretry, fail_times, **kw)


def test_retry_budget_and_validation():
    for mod in (tretry, rretry):
        pol = mod.fast_retry()
        with pytest.raises(mod.GiveUpError):
            pol.call(lambda: (_ for _ in ()).throw(OSError("x")),
                     budget_s=0.0)
        with pytest.raises(ValueError):                   # not transient
            pol.call(lambda: (_ for _ in ()).throw(ValueError("logic")))
        for bad in ({"max_attempts": 0}, {"jitter": 2.0},
                    {"op_timeout_s": 0}):
            with pytest.raises(ValueError):
                mod.RetryPolicy(**bad)
    assert not issubclass(tretry.GiveUpError, OSError)
    assert tretry.TRANSIENT_ERRORS == rretry.TRANSIENT_ERRORS
    for op in ("a", "read:node:07"):
        for a in range(6):
            assert tretry.RetryPolicy().delay_s(op, a) == \
                rretry.RetryPolicy().delay_s(op, a)


# ------------------------------------------------------------------- faults
def _fault_stream(mod, seed):
    """Every observable of a seeded rule set over a mixed op stream."""
    slept = []
    inj = mod.FaultInjector(seed=seed, sleep=slept.append)
    inj.add(op="write", match="node:03", kind="transient", times=3)
    inj.add(op="read", kind="corrupt", prob=0.3)
    inj.add(op="read", kind="latency", latency_s=0.5, prob=0.2)
    inj.add(kind="transient", prob=0.1)
    out = []
    rng = np.random.default_rng(seed)
    for i in range(120):
        op = ("read", "write", "rename")[i % 3]
        ref = f"node:{i % 7:02d}"
        share = [3, rng.integers(0, 256, 16).astype(np.int32),
                 rng.integers(0, 257, 16).astype(np.int32)]
        try:
            if op == "read":
                got = inj.apply_share(op, ref, share)
                out.append(("share", got is share, got[1].tolist()))
            else:
                inj.apply(op, ref)
                out.append(("ok",))
        except OSError as e:
            out.append(("err", str(e)))
    return out, slept, inj.fired_total, [s.fired for s in inj.specs]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_streams_draw_identically(seed):
    assert _fault_stream(tfaults, seed) == _fault_stream(rfaults, seed)


def test_fault_spec_validation_and_clear():
    with pytest.raises(ValueError):
        tfaults.FaultInjector().add(kind="meteor")
    inj = tfaults.FaultInjector()
    inj.add(kind="transient")
    inj.clear()
    inj.apply("write", "x")
    assert tfaults.FaultSpec.KINDS == rfaults.FaultSpec.KINDS


def _faulty_blob_trace(mod, blob_mod, tmp_path):
    inj = mod.FaultInjector(seed=5, sleep=lambda s: None)
    inj.add(op="write", kind="torn", torn_fraction=0.3, times=1)
    inj.add(op="write", match="c", kind="corrupt", times=1)
    inj.add(op="read", kind="corrupt", times=2)
    inj.add(op="read", match="t", kind="torn", torn_fraction=0.25, times=1)
    inj.add(op="rename", match="final", kind="transient", times=1)
    fb = mod.FaultyBlob(blob_mod.LocalBlob(fsync=False), inj)
    trace = []
    for name in ("a", "b", "c", "t"):
        path = tmp_path / name
        try:
            fb.write(path, bytes(range(200)))
            trace.append(("w", name))
        except OSError as e:
            trace.append(("w-err", name, str(e).replace(str(tmp_path), "")))
        trace.append(("r", name, fb.read(path)))
    for dst in ("final", "final", "other"):
        try:
            fb.rename(tmp_path / "a", tmp_path / dst)
            fb.rename(tmp_path / dst, tmp_path / "a")
            trace.append(("mv", dst))
        except OSError:
            trace.append(("mv-err", dst))
    return trace


def test_faulty_blob_identical(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    assert _faulty_blob_trace(tfaults, tblob, tmp_path / "p") == \
        _faulty_blob_trace(rfaults, rblob, tmp_path / "r")


# ------------------------------------------------------------------- events
def _scenario_rows(mod, layout_mod, n, k):
    layout = layout_mod.rack_layout(n, max(2, -(-n // (n - k))))
    scen = mod.standard_scenarios(n, k, layout)
    scen.append(mod.Scenario(
        "extra", tuple(mod.read_traffic(n, reads=9, seed=3))
        + (mod.delete(1.0, "obj"),)))
    return [(s.name, s.description, s.duration,
             [(e.t, e.kind, e.node, e.block, e.factor, e.where, e.positions,
               e.key) for e in s.events]) for s in scen]


@pytest.mark.parametrize("n,k", [(4, 2), (8, 4), (16, 8)])
def test_scenarios_identical(n, k):
    assert _scenario_rows(tevents, tplace, n, k) == \
        _scenario_rows(revents, rplace, n, k)
    assert tevents.default_layout(n, k) == tplace.RackLayout(
        **revents.default_layout(n, k).__dict__)


def test_event_constructors_and_validation():
    assert tevents.KINDS == revents.KINDS
    for name in ("fail", "down", "up", "scrub", "slow", "read", "corrupt"):
        assert hasattr(tevents, name)
    assert tevents.corrupt(1.0, 2, "r", (3, 4)) == tevents.Event(
        t=1.0, kind="corrupt", node=2, where="r", positions=(3, 4))
    for bad in ({"kind": "explode"}, {"kind": "delete"},
                {"kind": "corrupt", "node": 1, "where": "z"},
                {"kind": "fail", "node": 0}):
        with pytest.raises(ValueError):
            tevents.Event(t=0.0, **bad)
    with pytest.raises(ValueError):
        tevents.multi_node_loss(4, 2, failures=3)
    with pytest.raises(ValueError):
        tevents.rack_failure(tplace.rack_layout(4, 1), 2)
    assert tevents.read_traffic(4, reads=0) == []
    assert tevents.Scenario("e", ()).duration == 0.0
    assert set(tcluster.__all__) <= set(rcluster.__all__)


# ------------------------------------------------------------------ metrics
def _metrics_summary(mod):
    log = mod.MetricsLog()
    link = mod.LinkModel(bandwidth_bps=2e8, request_overhead_s=2e-3)
    for i in range(23):
        path = ("systematic", "degraded", "failed")[i % 3]
        lat = link.fetch_s(4096 * (i + 1), 1.0 + i % 4) if path != \
            "degraded" else link.degraded_read_s(8192, [1.0, 3.5, 2.0])
        log.record_read(path, lat, 4096, corrupt=i % 5 == 0)
    log.record_repair(2, 9 * 4096, 2 * 16 * 4096)
    log.record_repair(1, 9 * 4096, 16 * 4096)
    log.record_scrub(16 * 4096, 1)
    log.record_scrub_skipped()
    with pytest.raises(ValueError):
        log.record_read("teleport", 0.0, 1)
    return (log.summary(), log.availability, log.degraded_fraction,
            log.repair_ratio_vs_rs, log.latency_stats(),
            mod.MetricsLog().summary(), mod.MetricsLog().repair_ratio_vs_rs,
            link.degraded_read_s(10, []))


def test_metrics_summaries_identical():
    assert _metrics_summary(tmetrics) == _metrics_summary(rmetrics)
