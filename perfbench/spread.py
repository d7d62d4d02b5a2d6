"""Summarise result lines of repeated runs: for each metric, the median
and the spread (interquartile distance over the median, Python's
``statistics.quantiles``) of each set of runs.

    python3 perfbench/spread.py setA/*.out -- setB/*.out

Each file's last line is a run's result; ``--`` separates sets.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path[:1] = [str(Path(__file__).resolve().parents[1])]

from perfbench.stats import spread  # noqa: E402


def load(paths: list[str]) -> list[dict]:
    out = []
    for p in paths:
        lines = Path(p).read_text().strip().splitlines()
        if lines:
            out.append(json.loads(lines[-1]))
    return out


def summary(runs: list[dict]) -> dict:
    names = sorted({k for r in runs for k in r["metrics"]})
    res = {}
    for name in names:
        vals = [r["metrics"][name]["value"] for r in runs
                if name in r["metrics"]]
        res[name] = {"n": len(vals), "median": statistics.median(vals),
                     "spread": spread(vals) if len(vals) >= 2 else None,
                     "values": vals}
    res["correct"] = sum(bool(r["correct"]) for r in runs)
    return res


def main(argv: list[str]) -> int:
    sets, cur = [], []
    for a in argv:
        if a == "--":
            sets.append(cur)
            cur = []
        else:
            cur.append(a)
    sets.append(cur)
    for i, paths in enumerate(sets):
        print(json.dumps({"set": i, **summary(load(paths))}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
