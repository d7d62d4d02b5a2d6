"""The store's host stages on the process stage clock
(`repro_torch.exec.staging`): the key set of ``Pipeline.stage_stats()``,
that a put's and a drain tick's calling-thread stages account for their
wall time, one clock record a window or a call for per-share work, and
the stages as ``torch.profiler`` ranges when annotation is on."""
import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.circulant import CodeSpec
from repro_torch.exec import staging
from repro_torch.store import CodedObjectStore, RepairScheduler

C = [195, 101, 85, 228, 68, 59, 183, 160]
S = 1 << 12
DOCUMENTED = {"t_stage_read", "t_read_wait", "t_dispatch", "t_consume",
              "t_barrier", "t_pack", "t_h2d", "t_chunk", "t_commit",
              "t_crc", "t_install", "t_select", "t_gather", "t_tick_pump",
              "t_tick_drain", "t_fe_fetch", "t_fe_decode"}
# the calling thread's stages of each path
PUT = ("t_chunk", "t_read_wait", "t_dispatch", "t_consume", "t_barrier",
       "t_commit")
DRAIN = ("t_select", "t_read_wait", "t_dispatch", "t_consume", "t_barrier")


def make_store(depth=2, **kw):
    store = CodedObjectStore(CodeSpec.make(8, 257, c=C), n_nodes=20,
                             stripe_symbols=S, pipeline_depth=depth,
                             device="cpu", **kw)
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    return store, sched


def payload(seed, stripes=4):
    gen = np.random.default_rng(seed)
    return gen.integers(0, 256, stripes * 16 * S, np.uint8).tobytes()


def lose(store, node):
    store.fail_node(node)
    store.replace_node(node)


@pytest.fixture
def annotation():
    """Leaves the process-wide switch off whatever the test did."""
    yield staging.annotate
    staging.annotate(False)


def test_put_and_drain_tick_give_every_documented_stage():
    store, sched = make_store()
    with store:
        store.put("a", payload(0))
        store.pipeline.reset_stage_stats()
        store.put("a", payload(1))              # an overwrite: commit retires
        st = store.pipeline.stage_stats()
        assert set(st) == DOCUMENTED
        for key in PUT + ("t_crc", "t_install", "t_stage_read", "t_pack"):
            assert st[key] > 0.0, key
        assert st["t_select"] == 0.0

        lose(store, 3)
        store.pipeline.reset_stage_stats()
        rep = sched.drain()
        assert rep.repaired_shares > 0 and sched.pending() == 0
        st = store.pipeline.stage_stats()
        assert set(st) == DOCUMENTED
        for key in DRAIN + ("t_crc", "t_stage_read", "t_gather"):
            assert st[key] > 0.0, key
        assert st["t_chunk"] == st["t_commit"] == 0.0


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("path", ["put", "drain"])
def test_calling_thread_stages_account_for_the_wall_time(path, depth):
    store, sched = make_store(depth)
    with store:
        store.put("a", payload(0))
        store.put("b", payload(1))
        lose(store, 3)
        sched.drain_all()                       # warms the repair path
        if path == "drain":
            lose(store, 7)
        store.pipeline.reset_stage_stats()
        t0 = time.perf_counter()
        if path == "put":
            store.put("a", payload(2))
        else:
            assert sched.drain().repaired_shares > 0
        wall = time.perf_counter() - t0
        st = store.pipeline.stage_stats()
    stages = sum(st[k] for k in (PUT if path == "put" else DRAIN))
    assert stages <= wall
    assert stages >= 0.5 * wall, (stages, wall, st)


def test_reset_rebases_every_clock_stage():
    store, _ = make_store()
    with store:
        pipe = store.pipeline
        for key in staging.CLOCK_STAGES:
            staging.record_stage(key[2:], 1.0)
        store.put("a", payload(0, stripes=1))
        pipe.reset_stage_stats()
        assert all(v == 0.0 for v in pipe.stage_stats().values())
        for key in staging.CLOCK_STAGES:
            staging.record_stage(key[2:], 0.25)
        st = pipe.stage_stats()
    for key in staging.CLOCK_STAGES:
        assert st[key] == pytest.approx(0.25), key
    for key in staging.PIPELINE_STAGES:
        assert st[key] == 0.0, key


def test_tallied_records_a_loop_once_on_its_own_thread():
    def elsewhere():
        with staging.staged("x"):
            pass

    staging.reset_stage_times()
    with staging.tallied("x"):
        for _ in range(3):
            with staging.staged("x") as span:
                time.sleep(0.001)
            assert span.seconds >= 0.001
        with staging.tallied("x"):              # joins the open tally
            with staging.staged("x"):
                pass
        with staging.staged("y"):               # another stage: its own
            pass
        assert staging.stage_calls() == {"y": 1}
        th = threading.Thread(target=elsewhere)  # no tally on that thread
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        assert staging.stage_calls() == {"x": 1, "y": 1}
    calls, times = staging.stage_calls(), staging.stage_times()
    assert calls == {"x": 2, "y": 1} and times["x"] >= 0.003


def test_tallied_without_record_hands_its_own_sum_back():
    """``record=False`` yields the block's own ``[seconds, calls]`` and
    records nothing; an open tally of the name is set aside meanwhile
    and takes the blocks after it again."""
    staging.reset_stage_times()
    with staging.tallied("x") as outer:
        with staging.staged("x"):
            pass
        with staging.tallied("x", record=False) as acc:
            for _ in range(2):
                with staging.staged("x"):
                    time.sleep(0.001)
        assert acc[1] == 2 and acc[0] >= 0.002
        assert outer[1] == 1 and staging.stage_calls() == {}
        with staging.staged("x"):
            pass
        assert outer[1] == 2
    assert staging.stage_calls() == {"x": 1}
    with staging.tallied("y", record=False) as acc:
        pass
    assert acc == [0.0, 0] and staging.stage_calls() == {"x": 1}


def test_per_share_work_records_once_a_window():
    store, sched = make_store(put_tile_stripes=2, repair_tile_tasks=2)
    with store:
        store.put("a", payload(0))
        store.put("b", payload(1))
        lose(store, 3)
        staging.reset_stage_times()
        rep = sched.drain()
        windows = -(-rep.repaired_shares // 2)
        calls = staging.stage_calls()
        assert rep.repaired_shares > 2 and rep.batch_calls == windows
        assert calls["crc"] == windows          # 9 helper CRCs a share
        assert calls["gather"] == windows       # summed over its threads
        assert calls["select"] == calls["barrier"] == 1
        assert calls["read_wait"] == calls["dispatch"] == windows

        staging.reset_stage_times()
        store.put("a", payload(2))              # 4 stripes, 2 windows
        calls = staging.stage_calls()
    assert calls["crc"] == calls["install"] == 2    # 16 shares a window
    assert calls["chunk"] == calls["commit"] == calls["barrier"] == 1
    assert calls["read_wait"] == calls["dispatch"] == calls["consume"] == 2


def _profile_all_threads():
    """A profiler config that records every thread, where this torch has
    one (pool threads are otherwise not traced)."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def _traced_put(store):
    cfg = _profile_all_threads()
    kw = {} if cfg is None else {"experimental_config": cfg}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], **kw) as prof:
        store.put("a", payload(1))
    return cfg, [(e.name, e.thread) for e in prof.events()
                 if e.name.startswith(staging.RANGE_PREFIX)]


def test_annotation_puts_the_stages_on_the_profiler_timeline(annotation):
    store, _ = make_store()
    with store:
        store.put("a", payload(0))
        annotation(True)
        cfg, ranges = _traced_put(store)
    names = {name for name, _ in ranges}
    calling = {"repro_torch." + s[2:] for s in PUT}
    assert calling <= names, names
    main = {th for name, th in ranges if name == "repro_torch.chunk"}
    if cfg is not None:                         # the pool's install traced
        pool = {th for name, th in ranges if name == "repro_torch.crc"}
        assert pool and not pool & main


def test_annotation_off_leaves_no_range():
    store, _ = make_store()
    with store:
        store.put("a", payload(0))
        _, ranges = _traced_put(store)
    assert ranges == []


def _idle_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "idle_by_stage.py"
    spec = importlib.util.spec_from_file_location("idle_by_stage", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_by_stage_cuts_gaps_at_the_program_ranges():
    from perfbench import profile_reduce
    tool = _idle_tool()
    events = [  # (start_us, end_us, name, thread, on_card)
        (0.0, 100.0, "perfbench.window", 1, False),
        (10.0, 20.0, "kernel", 0, True),
        (60.0, 70.0, "Memcpy DtoH", 0, True),
        (0.0, 50.0, "repro_torch.read_wait", 1, False),
        (50.0, 90.0, "repro_torch.barrier", 1, False),
        (55.0, 58.0, "repro_torch.h2d", 1, False),
        (55.0, 80.0, "repro_torch.dispatch", 0, True),   # a mirror
        (30.0, 75.0, "repro_torch.crc", 2, False),
    ]
    out = tool.idle_by_stage(events, (0.0, 100.0), 1, profile_reduce)
    assert out["idle_s"] == pytest.approx(80e-6)
    assert out["busy_s"] == pytest.approx(20e-6)
    assert dict(out["idle_by_stage"]) == pytest.approx(
        {"read_wait": 40e-6, "barrier": 27e-6, "h2d": 3e-6,
         "outside any span": 10e-6})
    assert dict(out["idle_by_pool_stage"]) == pytest.approx(
        {"crc": 35e-6, "outside any span": 45e-6})
    assert out["range_mirrors"] == {"dispatch": 1}


def test_idle_by_stage_rehearses_a_cell_on_the_cpu(capsys):
    tool = _idle_tool()
    assert tool.main(["--workload", "hdfs-ingest", "--seed", "3",
                      "--seconds", "0.3", "--windows", "on,off",
                      "--device", "cpu", "--tiny"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["card"] == "cpu" and len(lines) == 3
    on, off = lines[1:]
    assert (on["annotate"], off["annotate"]) == (True, False)
    assert on["metrics"]["put_MBps"] > 0
    assert 0 <= on["metrics"]["put.unattributed_pct"] < 100
    stages = {name for name, _s in on["idle_by_stage"]}
    assert {"barrier", "read_wait"} <= stages
    assert dict(off["idle_by_stage"]) == {
        "outside any span": pytest.approx(off["idle_s"])}
