"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program (``src/repro_torch``).  The cell's configuration, traffic
mix and metrics are found by name from ``BENCHMARK.json``.  Exits non-zero
without a result when the host has fewer CUDA cards than the cell asks
for, when the program is missing, or when JAX or the JAX package was
loaded.  The last line of standard output is the result; the last lines
of standard error are the numbers the correctness check compared, each
beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the script's own directory would shadow modules of the standard
    # library; the checkout and its program are what the run imports
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    from perfbench import harness
    return harness.main(args, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
