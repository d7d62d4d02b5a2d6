"""The readers of the program's stage clock (``rec.counters["stage"]``,
``Pipeline.stage_stats()`` over the window) on synthetic records."""
import pytest

from perfbench import harness

# name: its value on the records below
PUT = {"put.chunk_ms_per_MiB": 1.0, "put.read_wait_ms_per_MiB": 2.0,
       "put.barrier_ms_per_MiB": 100.0, "put.commit_ms_per_MiB": 3.0,
       "put.crc_ms_per_MiB": 150.0, "put.unattributed_pct": 27.6}
DRAIN = {"drain.select_ms_per_MiB": 5.0, "drain.read_wait_ms_per_MiB": 400.0,
         "drain.barrier_ms_per_MiB": 50.0, "drain.crc_ms_per_MiB": 300.0,
         "drain.unattributed_pct": 4.0}
# what a program without the stages reports (the reference's keys)
OLD_KEYS = {"t_stage_read": 0.5, "t_pack": 0.1, "t_pad": 0.0,
            "t_dispatch": 0.1, "t_consume": 0.2}


def record(**kw):
    rec = harness.Record(cell="x", code={"k": 8, "n": 16, "p": 257,
                                         "S": 65536,
                                         "family": "double-circulant",
                                         "d": 9, "share_blocks": 2,
                                         "data_blocks": 16})
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def stages(**kw):
    out = dict.fromkeys(
        ("t_stage_read", "t_read_wait", "t_dispatch", "t_consume",
         "t_barrier", "t_pack", "t_h2d", "t_chunk", "t_commit", "t_crc",
         "t_select"), 0.0)
    out.update(kw)
    return out


def ingest():
    """4 MiB put in a 1 s window; the calling thread's stages 0.724 s."""
    return record(put_bytes=4 << 20, window_s=1.0, counters={
        "stage": stages(t_chunk=0.004, t_read_wait=0.008, t_dispatch=0.1,
                        t_consume=0.2, t_barrier=0.4, t_commit=0.012,
                        t_crc=0.6, t_stage_read=0.3)})


def repair():
    """16 shares of 2 S = 128 KiB rebuilt (2 MiB) in a 2 s window; the
    calling thread's stages 1.92 s."""
    return record(rebuilt_shares=16, window_s=2.0, counters={
        "stage": stages(t_select=0.01, t_read_wait=0.8, t_dispatch=0.5,
                        t_consume=0.51, t_barrier=0.1, t_crc=0.6,
                        t_stage_read=0.9)})


@pytest.mark.parametrize("name,want", sorted({**PUT, **DRAIN}.items()))
def test_reader_value_from_a_synthetic_record(name, want):
    rec = ingest() if name.startswith("put.") else repair()
    assert harness.load_reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted({**PUT, **DRAIN}))
def test_reader_reads_nothing_without_the_stages(name):
    read = harness.load_reader(name)
    assert read(record()) is None
    rec = ingest() if name.startswith("put.") else repair()
    rec.counters["stage"] = dict(OLD_KEYS)     # a program without them
    assert read(rec) is None


def test_the_readers_are_benchmark_json_s_stage_metrics():
    per_layer = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for names, layer, moves, cell in (
            (PUT, "store and pipeline", "put_MBps", "hdfs-ingest"),
            (DRAIN, "repair scheduler", "repair_MBps", "hdfs-repair")):
        for name in names:
            m = per_layer[name]
            assert (m["layer"], m["moves"], m["workloads"]) == \
                (layer, moves, [cell]), name
            assert m["source"] == "program_span" and m["better"] == "lower"
            assert m["unit"] == ("%" if name.endswith("_pct") else "ms/MiB")
