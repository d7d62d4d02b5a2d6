"""Find the highest rate an open-loop cell sustains: one set-up, then the
cell's traffic at each rate of a ladder for a few seconds each.

    python3 perfbench/knee.py --config <config> --traffic <mix> \\
        --seed <n> --rates 10,20,40 --seconds 8

``--config`` and ``--traffic`` name files under ``configs/`` and
``traffic/``, so a rate can be found before the cell exists; the mix's
driver must be ``open_loop``.

For each rate it prints the reads due and served, those shed, the 50th
and 95th percentile of latency from when a read was due, and how the
wait before a read's pump grew over the run (the mean of the last
quarter of reads over the first quarter).  The knee is the highest rate
with nothing shed and no growing wait; a cell's rate is written into
its traffic file as a number, at about four fifths of the knee.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="rate sweep of an open loop")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import deploy, harness, traffic_gen
    from perfbench.stats import nearest_rank
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 3
    cfg = deploy.load_config(args.config)
    mix = traffic_gen.load_mix(args.traffic)
    if mix["driver"] != "open_loop":
        raise SystemExit("a rate sweep needs an open-loop mix")
    t0 = time.perf_counter()
    cell = harness.Cell(f"{args.config}.{args.traffic}", cfg, mix,
                        args.seed, args.seconds)
    cell.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            ops = traffic_gen.open_schedule(dict(mix, rate_per_s=rate),
                                            len(cell.keys), args.seconds,
                                            args.seed + 1 + i)
            gen = traffic_gen.rng(args.seed + 1 + i,
                                  traffic_gen.STREAM_UPDATES)
            cell.payloads = [traffic_gen.payload(gen, cell.sizes[op.key])
                             for op in ops if op.kind == "put"]
            cell.rec = harness.Record(cell=cell.name, code=cell.rec.code)
            cell.attempted = cell.failed = 0
            shed0 = cell.fe.metrics.shed
            w0 = time.perf_counter()
            cell.driver.serve(cell, ops, record=True)
            wall = time.perf_counter() - w0
            rec = cell.rec
            lat = [x for x in rec.read_ms if x is not None]
            q = max(1, len(rec.wait_ms) // 4)
            first = statistics.mean(rec.wait_ms[:q]) if rec.wait_ms else 0
            last = statistics.mean(rec.wait_ms[-q:]) if rec.wait_ms else 0
            print(json.dumps({
                "rate_per_s": rate, "due": len(ops),
                "served": rec.reads_served,
                "shed": cell.fe.metrics.shed - shed0,
                "failed": cell.failed, "wall_s": wall,
                "p50_ms": nearest_rank(lat, 0.5),
                "p95_ms": nearest_rank(lat, 0.95),
                "wait_first_ms": first, "wait_last_ms": last,
                "service_ms": 1e3 * rec.pump_s / max(1, rec.reads_served)}),
                flush=True)
    finally:
        cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
