"""The metric arithmetic, the readers, and BENCHMARK.json against the
benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness, profile_reduce, roofline, stats

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_benchmark()


def record(**kw):
    rec = harness.Record(cell="x", code={"k": 8, "n": 16, "p": 257,
                                         "S": 65536})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_nearest_rank_and_spread():
    assert stats.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert stats.nearest_rank([3.0], 0.95) == 3.0
    assert stats.nearest_rank([], 0.95) is None
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_p95_ranks_failed_reads_above_every_served_one():
    read = harness.load_reader("get_p95_ms")
    served = [float(i) for i in range(1, 96)]
    assert read(record(read_ms=served + [None] * 5, window_s=0.01)) == 95.0
    # six failures push the 95th percentile onto a failed read, which
    # reads as the slower of the slowest served read and the window
    assert read(record(read_ms=served[:94] + [None] * 6,
                       window_s=0.01)) == 94.0
    assert read(record(read_ms=served[:94] + [None] * 6,
                       window_s=2.0)) == 2000.0


def test_roofline_byte_counts():
    assert roofline.encode_work(16, 8, 65536, 3) == (
        2 * 16 * 65536 * 3 * 4, 2 * 8 * 16 * 65536 * 3)
    assert roofline.regen_work(8, 65536, 5) == (11 * 65536 * 5 * 4,
                                               4 * 9 * 65536 * 5)
    assert roofline.decode_work(8, 4096, 10, 10) == (
        (16 * 10 + 10) * 4096 * 4, 4 * 8 * 10 * 4096)
    card = "NVIDIA H100 80GB HBM3"
    assert roofline.mem_peak(card) == 3.35e12
    assert roofline.mem_peak("NVIDIA H100 PCIe") == 2.0e12
    assert roofline.mem_peak("cpu") is None
    # 3.35 GB moved in 2 ms is half the bound of 1 ms
    assert roofline.roofline_pct(3.35e9, 0, 2e-3, card) == pytest.approx(50)
    assert roofline.roofline_pct(3.35e9, 0, 0.0, card) is None


def test_idle_share_from_synthetic_intervals():
    device = [(10.0, 20.0, "k"), (15.0, 30.0, "k"), (50.0, 60.0, "Memcpy"),
              (95.0, 130.0, "k")]
    host = [(0.0, 100.0, profile_reduce.WINDOW),
            (0.0, 35.0, "perfbench.put"), (35.0, 100.0, "perfbench.pump"),
            (42.0, 48.0, "perfbench.submit")]
    out = profile_reduce.reduce_events(device, host)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(35e-6)       # 10-30, 50-60, 95-100
    assert out["by_name"]["k"] == pytest.approx(30e-6)
    assert out["idle_by_host"] == pytest.approx(
        {"put": 10e-6, "pump": 55e-6})
    rec = record(trace=out)
    assert harness.load_reader("idle.get")(rec) == pytest.approx(65.0)


def test_every_metric_has_a_reader_that_reads_nothing_from_nothing():
    b = bench()
    names = {p.stem for p in harness.METRICS_DIR.glob("*.py")}
    assert {m["name"] for m in b["end_to_end"] + b["per_layer"]} <= names
    for name in names:
        read = harness.load_reader(name)
        if name != "setup_s":
            assert read(record()) is None, name


def test_benchmark_file_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json") \
            .exists()
        cells.add(w["name"])
    assert {w["config"] for w in b["workloads"]} == configs
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + list(cells) + list(configs):
        assert NAME.match(name), name
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        e2e_here = harness.metric_specs(b, cell, False)
        assert "setup_s" in {m["name"] for m in e2e_here}
        assert len(e2e_here) >= 2
        assert harness.metric_specs(b, cell, True)
    assert len(json.dumps(b)) < 64 << 10


def test_placement_rule_catches_a_bad_placement():
    from perfbench import verify
    assert verify.placement_ok(tuple(range(1, 17)), 16, 20)
    assert not verify.placement_ok((1,) * 16, 16, 20)
    assert not verify.placement_ok(tuple(range(1, 16)), 16, 20)
    assert not verify.placement_ok(tuple(range(5, 21)) + (0,), 16, 20)
    assert not verify.placement_ok(tuple(range(6, 22)), 16, 20)
