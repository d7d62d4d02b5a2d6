"""The reader of the repair gather's engagement, ``drain.gather_threads``
(``t_gather / t_read_wait`` of ``rec.counters["stage"]``), on synthetic
records, and its entry in BENCHMARK.json."""
import pytest

from perfbench import harness

NAME = "drain.gather_threads"


def record(stage=None):
    rec = harness.Record(cell="x", code={"k": 8, "n": 16, "p": 257,
                                         "S": 65536,
                                         "family": "double-circulant",
                                         "d": 9, "share_blocks": 2,
                                         "data_blocks": 16})
    rec.rebuilt_shares, rec.window_s = 16, 2.0
    if stage is not None:
        rec.counters = {"stage": stage}
    return rec


@pytest.mark.parametrize("gather,wait,want", [
    (3.0, 1.0, 3.0), (0.8, 0.8, 1.0), (0.0, 0.5, 0.0)])
def test_reader_is_gather_thread_seconds_over_the_wait(gather, wait, want):
    rec = record({"t_read_wait": wait, "t_gather": gather, "t_crc": 0.4})
    assert harness.load_reader(NAME)(rec) == pytest.approx(want)


@pytest.mark.parametrize("stage", [
    None,                                       # no stage clock at all
    {"t_read_wait": 0.8, "t_crc": 0.6},         # a program without t_gather
    {"t_read_wait": 0.0, "t_gather": 0.0},      # nothing waited on
])
def test_reader_reads_nothing_without_the_stage(stage):
    assert harness.load_reader(NAME)(record(stage)) is None


def test_the_reader_is_benchmark_json_s_engagement_metric():
    per_layer = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert per_layer[NAME] == {
        "name": NAME, "unit": "threads", "better": "higher",
        "source": "program_span", "layer": "repair scheduler",
        "moves": "repair_MBps", "workloads": ["hdfs-repair"]}
