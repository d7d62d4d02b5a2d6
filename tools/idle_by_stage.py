#!/usr/bin/env python
"""Idle time of the card in one benchmark cell, by the store's stage.

Sets up a cell of the benchmark (``BENCHMARK.json``) as its harness does,
then runs the cell's window once or more in the same process, each with
the program's stage annotation on or off
(`repro_torch.exec.staging.annotate`) and, with ``--trace 1``, under
``torch.profiler`` with every thread traced.  For each window it prints
one JSON line:

* ``metrics``: the cell's end-to-end rate and the per-layer metrics that
  read the program's own stages (``Pipeline.stage_stats()``);
* ``idle_s``: seconds of the window with no kernel, copy or set on the
  card (the gaps of ``perfbench.profile_reduce``), and, with annotation
  on, those seconds grouped by the innermost program range
  ``repro_torch.<stage>`` covering them on the calling thread
  (``idle_by_stage``) and on the pool's threads (``idle_by_pool_stage``);
  a gap is cut at the ranges' edges so each piece gets its own range;
* ``range_mirrors``: how many of the program's ranges also appear on the
  device timeline, by stage (a ``record_function`` range leaves one
  there, which a reducer that takes every device event as work would
  count as busy time).

Windows in one process share one set-up, so ``--windows off,on,on,off``
compares the rate with annotation off and on, in turns.

    python3 tools/idle_by_stage.py --workload hdfs-ingest --seed 7 \\
        --seconds 20 --windows on,off --trace 1

Runs on the card (``device=None``, as the benchmark); ``--device cpu
--tiny`` rehearses it on the CPU at the benchmark tests' tiny size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "repro_torch."


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", default="on",
                    help="annotation of each window, in order: on / off")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default=None, help="cpu to rehearse")
    ap.add_argument("--tiny", action="store_true",
                    help="the benchmark tests' tiny configuration")
    return ap.parse_args(argv)


def profiler(torch, on_card: bool):
    """A ``torch.profiler.profile`` of the host and the card that traces
    every thread where this torch can (pool threads otherwise are not)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return torch.profiler.profile(activities=acts,
                                      experimental_config=cfg)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=acts)


def _pieces(a: float, b: float, ranges: list) -> list[tuple[float, float]]:
    """[a, b] cut at the edges of ``ranges`` that fall inside it."""
    cuts = sorted({x for lo, hi, _n in ranges for x in (lo, hi)
                   if a < x < b})
    edges = [a] + cuts + [b]
    return list(zip(edges[:-1], edges[1:]))


def idle_by_stage(events: list, window: tuple, calling_thread,
                  reduce) -> dict:
    """The window's idle seconds grouped by the innermost program range
    on the calling thread and on the other threads.  ``events`` are
    (start_us, end_us, name, thread, on_card)."""
    lo, hi = window
    busy, calling, pool, mirrors = [], [], [], {}
    for a, b, name, thread, on_card in events:
        program = name.startswith(PROGRAM)
        if on_card:
            if program:
                stage = name[len(PROGRAM):]
                mirrors[stage] = mirrors.get(stage, 0) + 1
            elif not name.startswith(reduce.PREFIX) and b > lo and a < hi:
                busy.append((max(a, lo), min(b, hi)))
        elif program:
            rng = (a, b, name[len(PROGRAM):])
            (calling if thread == calling_thread else pool).append(rng)
    by_calling: dict[str, float] = {}
    by_pool: dict[str, float] = {}
    idle = 0.0
    for a, b in reduce.gaps(busy, lo, hi):
        idle += (b - a) / 1e6
        near_calling = [r for r in calling if r[0] < b and r[1] > a]
        near_pool = [r for r in pool if r[0] < b and r[1] > a]
        for x, y in _pieces(a, b, near_calling + near_pool):
            mid = (x + y) / 2
            for out, rngs in ((by_calling, near_calling),
                              (by_pool, near_pool)):
                what = reduce.label(mid, rngs)
                out[what] = out.get(what, 0.0) + (y - x) / 1e6
    return {"window_s": (hi - lo) / 1e6, "idle_s": idle,
            "busy_s": reduce.union_s(busy) / 1e6,
            "idle_by_stage": reduce.top(by_calling, 20),
            "idle_by_pool_stage": reduce.top(by_pool, 20),
            "range_mirrors": mirrors}


def trace_events(prof, torch) -> tuple[list, tuple, object]:
    """(events, the benchmark's window span, its thread) of a profile."""
    from perfbench import profile_reduce
    on_card = torch.autograd.DeviceType.CUDA
    events, window, thread = [], None, None
    for e in prof.events():
        card = e.device_type == on_card
        events.append((e.time_range.start, e.time_range.end, e.name,
                       e.thread, card))
        if e.name == profile_reduce.WINDOW and not card:
            window, thread = (e.time_range.start, e.time_range.end), e.thread
    if window is None:
        raise RuntimeError("no window span in the trace")
    return events, window, thread


def run_window(cell, seconds: float, trace: bool, annotate: bool):
    """One window of the cell's driver, as the harness runs it; returns
    the finished profile or None."""
    import torch
    from perfbench import harness
    from perfbench.profile_reduce import span
    from repro_torch.exec import staging
    cell.rec = harness.Record(cell=cell.name, code=cell.rec.code)
    cell.trace = trace
    cell.store.pipeline.reset_stage_stats()
    prof = profiler(torch, cell.device != "cpu") if trace else None
    staging.annotate(annotate)
    if prof is not None:
        prof.__enter__()
    try:
        with span("window", trace):
            t0 = time.perf_counter()
            cell.driver.window(cell, t0, seconds)
            cell.sync()
            cell.rec.window_s = time.perf_counter() - t0
    finally:
        staging.annotate(False)
        if prof is not None:
            prof.__exit__(None, None, None)
    cell.rec.counters["stage"] = cell.store.pipeline.stage_stats()
    cell.finish()               # the open drain, outside the window
    return prof


def window_line(bench, cell, prof, annotate: bool, trace: bool) -> dict:
    import torch
    from perfbench import harness, profile_reduce
    specs = [m for m in harness.metric_specs(bench, cell.name, False)
             if m["name"] != "setup_s"]
    specs += [m for m in harness.metric_specs(bench, cell.name, True)
              if m["source"] in ("program_span", "program_counter")]
    line = {"annotate": annotate, "trace": trace,
            "window_s": cell.rec.window_s,
            "metrics": {k: v["value"] for k, v in
                        harness.read_metrics(specs, cell.rec).items()},
            "stages": cell.rec.counters["stage"]}
    if prof is not None:
        events, window, thread = trace_events(prof, torch)
        line.update(idle_by_stage(events, window, thread, profile_reduce))
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from perfbench import deploy, harness, tiny, traffic_gen
    if args.device != "cpu" and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 3
    modes = [w.strip() for w in args.windows.split(",")]
    if not modes or set(modes) - {"on", "off"}:
        print(f"--windows takes on / off, got {args.windows!r}",
              file=sys.stderr)
        return 2
    bench = tiny.bench() if args.tiny else harness.load_benchmark()
    entry = harness.cell_entry(bench, args.workload)
    if args.tiny:
        cfg, mix = tiny.config(entry["config"]), tiny.mix(entry["traffic"])
    else:
        cfg = deploy.load_config(entry["config"],
                                 harness.config_file(bench, entry["config"]))
        mix = traffic_gen.load_mix(entry["traffic"])
    cell = harness.Cell(args.workload, cfg, mix, args.seed, args.seconds,
                        device=args.device, trace=bool(args.trace))
    card = torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"
    try:
        t0 = time.perf_counter()
        cell.setup()
        print(json.dumps({"cell": args.workload, "seed": args.seed,
                          "card": card, "setup_s": time.perf_counter() - t0}),
              flush=True)
        for mode in modes:
            on = mode == "on"
            prof = run_window(cell, args.seconds, bool(args.trace), on)
            print(json.dumps(window_line(bench, cell, prof, on,
                                         bool(args.trace))), flush=True)
    finally:
        cell.close()
    return 0


if __name__ == "__main__":
    # the checkout and its program are what the run imports, and its
    # builds stay inside the checkout, as the benchmark's own runs
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "cuda_cache"))
    sys.exit(main())
