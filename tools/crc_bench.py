#!/usr/bin/env python
"""Time the store's share check, `share_crc`, a check at a time.

For each stripe unit S (symbols of a share's two int32 blocks) and each
thread count, checks distinct shares for ``--seconds`` with the store's
`share_crc` (the native library, `csrc/share_crc.cpp`) and with the numpy
formula it keeps for hosts without a C++ compiler, and prints one JSON
line each:

* ``us_per_check``: the window's wall time over the checks completed by
  all its threads (at 1 thread, the latency of a check);
* ``MBps``: the shares' int32 bytes checked a second;
* ``paths``: the checks each path of `share_crc_paths()` counted in the
  window (``clmul``, ``table`` or ``numpy``; the formula, called here
  directly, counts in none).

A last line gives the host (CPU model, cores) and the native over numpy
ratio of each (S, threads).  Each thread cycles through shares of its own,
``--pool-mib`` of them, so a check reads memory as the store's do.

    PYTHONPATH=src python3 tools/crc_bench.py --seconds 2 --threads 1,4

Runs on the host's CPU alone; nothing here touches a card.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.codes import crc  # noqa: E402


def cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def shares(S: int, count: int, seed: int) -> list[tuple[np.ndarray, ...]]:
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, S, dtype=np.int32),
             rng.integers(0, 257, S, dtype=np.int32)) for _ in range(count)]


def window(fn, pools: list, seconds: float) -> int:
    """Checks completed by ``len(pools)`` threads, each cycling through its
    pool for ``seconds``."""
    done = [0] * len(pools)
    start = threading.Barrier(len(pools))

    def work(i: int) -> None:
        pool = pools[i]
        start.wait()
        end = time.perf_counter() + seconds
        n = 0
        while time.perf_counter() < end:
            a, r = pool[n % len(pool)]
            fn(a, r)
            n += 1
        done[i] = n

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(pools))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return sum(done)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stripes", default="4096,1048576",
                    help="stripe units S, comma-separated")
    ap.add_argument("--threads", default="1,4")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--pool-mib", type=float, default=64.0,
                    help="int32 MiB of shares each thread cycles through")
    args = ap.parse_args(argv)
    impls = {"native": crc.share_crc,
             "numpy": crc._share_crc_numpy}
    crc.share_crc(*shares(16, 1, 0)[0])      # build and load first
    ratios = {}
    for S in (int(x) for x in args.stripes.split(",")):
        per = max(2, int(args.pool_mib * 2**20 // (8 * S)))
        for n_threads in (int(x) for x in args.threads.split(",")):
            pools = [shares(S, per, 1000 * S + i) for i in range(n_threads)]
            for a, r in pools[0]:       # the two agree on these shares
                assert impls["native"](a, r) == impls["numpy"](a, r)
            us = {}
            for name, fn in impls.items():
                before = crc.share_crc_paths()
                t0 = time.perf_counter()
                checks = window(fn, pools, args.seconds)
                wall = time.perf_counter() - t0
                after = crc.share_crc_paths()
                us[name] = wall / checks * 1e6
                print(json.dumps({
                    "S": S, "threads": n_threads, "impl": name,
                    "checks": checks, "us_per_check": us[name],
                    "MBps": checks * 8 * S / wall / 1e6,
                    "paths": {k: after[k] - before[k] for k in after}}),
                    flush=True)
            ratios[f"{S}x{n_threads}"] = us["numpy"] / us["native"]
    print(json.dumps({"cpu": cpu_model(), "cores": os.cpu_count(),
                      "python": platform.python_version(),
                      "native_over_numpy": ratios}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
