"""The reader of the put install's engagement, ``put.install_threads``
(``t_install / t_barrier`` of ``rec.counters["stage"]``), on synthetic
records, and its entry in BENCHMARK.json."""
import pytest

from perfbench import harness

NAME = "put.install_threads"


def record(stage=None):
    rec = harness.Record(cell="x", code={"k": 8, "n": 16, "p": 257,
                                         "S": 1 << 20,
                                         "family": "double-circulant",
                                         "d": 9, "share_blocks": 2,
                                         "data_blocks": 16})
    rec.put_bytes, rec.window_s = 1 << 27, 2.0
    if stage is not None:
        rec.counters = {"stage": stage}
    return rec


@pytest.mark.parametrize("install,barrier,want", [
    (3.0, 1.0, 3.0), (0.8, 0.8, 1.0), (0.0, 0.5, 0.0)])
def test_reader_is_install_thread_seconds_over_the_barrier(install, barrier,
                                                           want):
    rec = record({"t_barrier": barrier, "t_install": install, "t_crc": 0.4})
    assert harness.load_reader(NAME)(rec) == pytest.approx(want)


@pytest.mark.parametrize("stage", [
    None,                                       # no stage clock at all
    {"t_barrier": 0.8, "t_crc": 0.6},           # a program without t_install
    {"t_barrier": 0.0, "t_install": 0.0},       # nothing waited on
])
def test_reader_reads_nothing_without_the_stage(stage):
    assert harness.load_reader(NAME)(record(stage)) is None


def test_the_reader_is_benchmark_json_s_engagement_metric():
    per_layer = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert per_layer[NAME] == {
        "name": NAME, "unit": "threads", "better": "higher",
        "source": "program_span", "layer": "store and pipeline",
        "moves": "put_MBps", "workloads": ["hdfs-ingest"]}
