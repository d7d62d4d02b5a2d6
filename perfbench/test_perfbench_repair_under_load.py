"""The repair-under-load cell's readers on synthetic records, its mix,
and its driver's node order and counting on the CPU at the tiny size."""
import pytest

from perfbench import harness, tiny, traffic_gen, verify

CELL = "rgw-repair-under-load"
# name: its value on ``loaded()``
READERS = {"tick.drain_pct": 60.0, "tick.pump_pct": 30.0,
           "fe.fetch_ms_per_MiB": 50.0, "fe.decode_ms_per_MiB": 2.5,
           "fe.degraded_pct": 25.0}
# what each reader needs: the stage or the counter it reads
NEEDS = {"tick.drain_pct": ("stage", "t_tick_drain"),
         "tick.pump_pct": ("stage", "t_tick_pump"),
         "fe.fetch_ms_per_MiB": ("stage", "t_fe_fetch"),
         "fe.decode_ms_per_MiB": ("stage", "t_fe_decode"),
         "fe.degraded_pct": ("fe", "stripes_read")}


def record(**kw):
    rec = harness.Record(cell="x", code={"k": 8, "n": 16, "p": 257,
                                         "S": 4096,
                                         "family": "double-circulant",
                                         "d": 9, "share_blocks": 2,
                                         "data_blocks": 16})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def loaded():
    """A 2 s window: 1.2 s of drain and 0.6 s of pump on the dispatcher,
    8 MiB of reads served (0.4 s fetching, 20 ms decoding), 64 of 256
    stripes read degraded."""
    return record(window_s=2.0, counters={
        "stage": {"t_tick_drain": 1.2, "t_tick_pump": 0.6,
                  "t_fe_fetch": 0.4, "t_fe_decode": 0.02},
        "reads": {"bytes": 8 << 20},
        "fe": {"stripes_read": 256, "degraded_stripes": 64}})


@pytest.mark.parametrize("name,want", sorted(READERS.items()))
def test_reader_value_from_a_synthetic_record(name, want):
    assert harness.load_reader(name)(loaded()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_its_stage_or_counter(name):
    read = harness.load_reader(name)
    assert read(record()) is None
    rec = loaded()
    group, key = NEEDS[name]
    del rec.counters[group][key]          # a program without it
    assert read(rec) is None
    if group == "stage":                  # nothing served: nothing per MiB
        rec = loaded()
        rec.counters["reads"]["bytes"] = 0
        assert (read(rec) is None) == name.endswith("_per_MiB")


def test_the_cell_and_its_metrics_in_benchmark_json():
    b = harness.load_benchmark()
    entry = harness.cell_entry(b, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == \
        ("dc16-rgw4m", CELL, 1)
    e2e = {m["name"] for m in harness.metric_specs(b, CELL, False)}
    assert e2e == {"repair_MBps", "setup_s"}
    layer = {m["name"]: m for m in harness.metric_specs(b, CELL, True)}
    assert set(layer) == set(READERS)
    for name, m in layer.items():
        assert m["workloads"] == [CELL] and m["moves"] == "repair_MBps"
        assert m["source"] == ("program_counter" if name == "fe.degraded_pct"
                               else "program_span")


def test_the_mix_is_ycsb_b_with_ceph_s_recovery_chunk():
    mix = traffic_gen.load_mix(CELL)
    assert mix["driver"] == "repair_under_load"
    assert (mix["read_share"], mix["zipfian_constant"]) == (0.95, 0.99)
    assert mix["repair_budget_symbols"] == 8 << 20
    assert mix["rate_per_s"] > 0 and mix["warmup_s"] == 5


def _cell(seed, seconds=0.6, **mix):
    entry = harness.cell_entry(tiny.bench(), CELL)
    return harness.Cell(CELL, tiny.config(entry["config"]),
                        dict(tiny.mix(entry["traffic"]), **mix), seed,
                        seconds, device="cpu")


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_nodes_fail_one_at_a_time_in_the_seeded_order(seed):
    cell = _cell(seed)
    failed = []
    down_at_once = []
    orig = cell.fail_replace

    def fail_replace(node):
        # every earlier node is whole again when the next one is lost
        down_at_once.append(sum(
            1 for other in failed
            if verify.present(cell.store, cell.ledger.shares_on(other),
                              other) < len(cell.ledger.shares_on(other))))
        failed.append(node)
        return orig(node)

    cell.fail_replace = fail_replace
    try:
        cell.setup()
        cell.window()
        cell.finish()
        checks = cell.check()
    finally:
        cell.close()
    order = traffic_gen.node_order(cell.n_nodes, seed)
    assert failed == [order[i % len(order)] for i in range(len(failed))]
    assert len(failed) > 3 and not any(down_at_once)
    assert checks["share_missing"] == checks["share_mismatch"] == 0
    assert checks["read_mismatch"] == checks["read_error"] == 0
    assert checks["reads_checked"] > 0


def test_the_node_in_flight_at_the_close_counts_what_the_store_holds():
    # a budget of one task a tick: the close finds a node in flight
    cell = _cell(5, seconds=0.4, repair_budget_symbols=9 * 256)
    losses = []
    orig = cell.fail_replace

    def fail_replace(node):
        losses.append(orig(node))
        return losses[-1]

    try:
        cell.setup()
        cell.fail_replace = fail_replace
        cell.window()
        rec, node = cell.rec, cell.open_node
        assert node is not None
        held = verify.present(cell.store, cell.node_shares, node)
        done = rec.counters["tick"]["nodes"]
        assert len(losses) == done + 1
        assert rec.rebuilt_shares == sum(losses[:-1])
        assert 0 <= held <= losses[-1]
        cell.finish()
        assert rec.rebuilt_shares == sum(losses[:-1]) + held
        assert cell.sched.pending() == 0
        assert cell.attempted >= sum(losses) and cell.failed == 0
        assert rec.drain["repaired_shares"] > 0
        checks = cell.check()
    finally:
        cell.close()
    assert checks["share_missing"] == checks["share_mismatch"] == 0


@pytest.mark.parametrize("fault", ["pump_unchanged", "pump_half"])
def test_the_pump_s_planted_faults_come_out_not_correct(monkeypatch, fault):
    cell = _cell(7)
    try:
        cell.setup()
        owner, name, fn = cell.driver.FAULTS[fault]()
        monkeypatch.setattr(owner, name, fn)
        cell.window()
        cell.finish()
        checks = cell.check()
    finally:
        monkeypatch.undo()
        cell.close()
    assert checks["read_error"] > 0 or checks["read_mismatch"] > 0, checks
