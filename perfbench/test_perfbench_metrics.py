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
                                         "S": 65536,
                                         "family": "double-circulant",
                                         "d": 9, "share_blocks": 2,
                                         "data_blocks": 16})
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


CARD = "NVIDIA H100 80GB HBM3"
DRAIN_STAGES = {"drain.select_ms_per_MiB": "t_select",
                "drain.read_wait_ms_per_MiB": "t_read_wait",
                "drain.barrier_ms_per_MiB": "t_barrier",
                "drain.crc_ms_per_MiB": "t_crc"}


def repair_record(code: dict):
    """A traced repair window of 1000 shares rebuilt in 50 s, S = 2^20."""
    rec = harness.Record(cell="x", code=code, card=CARD)
    rec.rebuilt_shares, rec.window_s = 1000, 50.0
    rec.drain = {"symbols_moved": 9 << 30, "rs_baseline_symbols": 16 << 30}
    rec.counters = {"stage": {"t_select": 0.25, "t_read_wait": 20.0,
                              "t_barrier": 1.5, "t_crc": 9.0,
                              "t_dispatch": 2.0, "t_consume": 3.0}}
    rec.trace = {"by_name": {"gf_matmul_kernel<64, 8, true>": 0.08,
                             "Memcpy DtoH (Device -> Pageable)": 4.0},
                 "busy_s": 5.0, "window_s": 50.0, "idle_by_host": {}}
    return rec


def test_double_circulant_repair_readers_read_as_before():
    """The values of the formulas the readers had before they counted a
    share by the family's blocks (2 S bytes a share, d = k + 1 helper
    blocks in), from the same record, bit for bit."""
    s = 1 << 20
    rec = repair_record({"k": 8, "n": 16, "p": 257, "S": s,
                         "family": "double-circulant", "d": 9,
                         "share_blocks": 2, "data_blocks": 16})
    read = harness.load_reader
    assert read("repair_MBps")(rec) == 1000 * 2 * s / 50.0 / 1e6
    mib = 1000 * 2 * s / 2 ** 20
    for name, key in DRAIN_STAGES.items():
        assert read(name)(rec) == 1e3 * rec.counters["stage"][key] / mib
    assert read("copy.repair_ms_per_MiB")(rec) == 1e3 * 4.0 / mib
    least = max((8 + 3) * s * 1000 * 4 / 3.35e12,
                2 * 2 * (8 + 1) * s * 1000 / 67e12)
    assert read("gf_matmul_roofline.regen")(rec) == 100.0 * least / 0.08


def test_product_matrix_counts_by_hand():
    """(16, 8, 14): alpha = 7 blocks a share, 56 a stripe; a share
    rebuilt is 14 helper sends (7 blocks in, 1 out each) and the
    newcomer's product (14 in, 7 out): 98 + 14 + 14 + 7 = 133 blocks,
    and 7 x 14 + 7 x 14 = 196 multiply-adds a symbol column."""
    from perfbench import deploy
    s = 1 << 20
    geo = deploy.geometry({"family": "product-matrix", "n": 16, "k": 8,
                           "d": 14, "p": 257})
    assert geo == {"n": 16, "d": 14, "share_blocks": 7, "data_blocks": 56}
    assert roofline.pm_regen_work(14, 7, s, 1) == (133 * 4 * s, 392 * s)
    assert roofline.pm_regen_work(14, 7, s, 1000) == (
        557842432000, 411041792000)
    rec = repair_record({"k": 8, "p": 257, "S": s,
                         "family": "product-matrix", **geo})
    read = harness.load_reader
    assert read("repair_MBps")(rec) == pytest.approx(
        1000 * 7 * s / 50.0 / 1e6)                      # 146.8 MB/s
    assert read("drain.select_ms_per_MiB")(rec) == pytest.approx(
        250.0 / 7000)
    # 557.8 GB at 3.35 TB/s is 166.5 ms, a third of 500 ms of the kernel
    rec.trace["by_name"] = {"gf_matmul_kernel<64, 8, true>": 0.5}
    assert read("gf_matmul_roofline.regen")(rec) == pytest.approx(
        100.0 * 557842432000 / 3.35e12 / 0.5)


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
