"""The benchmark's cells cut to a size the CPU tests can run in seconds:
the same code, the same placement and the same traffic, on small
stripes, few small objects and short windows.

The cells are ``BENCHMARK.json``'s, so a cell added there is tested
with the rest.  ``RIGS`` add a run for each driver that no cell uses
yet, on a configuration of its own and a mix given here, so that a
later cell can take the driver up with data files alone: the read path
through the front end, as the read cells that were measured and left
out of ``BENCHMARK.json`` ran it.  A rig may also run a configuration
that no cell has yet, given here inline (``CONFIGS``): the
product-matrix code under closed-loop repair.
"""
from __future__ import annotations

import copy
import time
from pathlib import Path

from perfbench import deploy, harness, traffic_gen

DRIVERS_DIR = Path(__file__).resolve().parent / "drivers"

READS = {"driver": "open_loop", "rate_per_s": 40.0, "zipfian_constant": 0.99,
         "warmup_s": 0.3}
# configurations of the rigs that no file under configs/ holds yet
CONFIGS = {
    "pm16-tiny": {
        "name": "pm16-tiny",
        "code": {"family": "product-matrix", "n": 16, "k": 8, "d": 14,
                 "p": 257, "g": list(range(1, 17)),
                 "default_c": [195, 101, 85, 228, 68, 59, 183, 160]},
        "store": {"n_nodes": 20, "n_racks": None, "stripe_symbols": 256},
        "objects": {"count": 6, "size_dist": "fixed"}},
}
REPAIR_LAYERS = [("gf_matmul_roofline.regen", "%"), ("idle.repair", "%"),
                 ("copy.repair_ms_per_MiB", "ms/MiB"),
                 ("drain.traffic_vs_rs", "ratio"),
                 ("drain.select_ms_per_MiB", "ms/MiB"),
                 ("drain.read_wait_ms_per_MiB", "ms/MiB"),
                 ("drain.barrier_ms_per_MiB", "ms/MiB"),
                 ("drain.crc_ms_per_MiB", "ms/MiB"),
                 ("drain.unattributed_pct", "%"),
                 ("drain.gather_threads", "threads")]
# name: (configuration, mix, end-to-end metrics, per-layer metrics)
RIGS = {
    "rgw-degraded-read": (
        "dc16-rgw4m", dict(READS, name="rgw-degraded-read", read_share=1.0,
                           lost_nodes=[7]),
        [("get_p95_ms", "ms")],
        [("gf_matmul_roofline.decode", "%"), ("idle.get", "%"),
         ("frontend.wait_p95_ms", "ms"), ("frontend.service_ms", "ms"),
         ("plan.compiles.get", "count")]),
    "rgw-read-update": (
        "dc16-rgw4m", dict(READS, name="rgw-read-update", read_share=0.95,
                           lost_nodes=[]),
        [("get_p95_ms", "ms")],
        [("idle.get", "%"), ("frontend.service_ms", "ms")]),
    "pm16-drain": (
        "pm16-tiny", {"name": "pm16-drain", "driver": "repair_loop"},
        [("repair_MBps", "MB/s")], REPAIR_LAYERS),
}


def bench() -> dict:
    """BENCHMARK.json with the rigs added as cells, each reporting its
    metrics and ``setup_s``."""
    b = copy.deepcopy(harness.load_benchmark())
    have = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for rig, (cfg, _mix, e2e, layer) in RIGS.items():
        b["workloads"].append({"name": rig, "config": cfg, "traffic": rig,
                               "chips": 1, "why": ""})
        for group, names, moves in (("end_to_end", e2e, None),
                                    ("per_layer", layer, e2e[0][0])):
            for name, unit in names:
                if name not in have:
                    have[name] = {"name": name, "unit": unit,
                                  "better": "lower", "workloads": []}
                    if moves:
                        have[name]["moves"] = moves
                    b[group].append(have[name])
                have[name].setdefault("workloads", []).append(rig)
    return b


def cells() -> list[str]:
    """Every cell of BENCHMARK.json, then the rigs."""
    return [w["name"] for w in harness.load_benchmark()["workloads"]] + \
        list(RIGS)


def drivers() -> list[str]:
    return sorted(p.stem for p in DRIVERS_DIR.glob("*.py"))


def config(name: str) -> dict:
    """The configuration ``name`` (a rig's, or its file) on stripes of
    256 symbols and 6 objects of 4 stripes of the family's data blocks:
    24 stripes, more than the 20 nodes, so every node holds shares of
    stripes that lose no other node (a later failure's full decode
    cannot quietly redo a missing repair)."""
    cfg = copy.deepcopy(CONFIGS[name] if name in CONFIGS
                        else deploy.load_config(name))
    cfg["store"]["stripe_symbols"] = 256
    largest = 3 * deploy.geometry(cfg["code"])["data_blocks"] * 256 + 100
    obj = cfg["objects"]
    if obj["size_dist"] == "fixed":
        obj.update(count=6, size_bytes=largest)
    else:
        obj.update(count=24, size_min=1000, size_max=largest)
    return cfg


def mix(name: str) -> dict:
    if name in RIGS:
        return dict(RIGS[name][1])
    m = traffic_gen.load_mix(name)
    if "warmup_s" in m:
        m["warmup_s"] = 0.3
    return m


def run(cell: str, seed: int = 3, seconds: float = 0.6,
        trace: bool = False, backend=None) -> dict:
    """One CPU run of ``cell`` at the tiny size; the result object."""
    b = bench()
    entry = harness.cell_entry(b, cell)
    return harness.run_cell(b, cell, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            config=config(entry["config"]),
                            mix=mix(entry["traffic"]), backend=backend)
