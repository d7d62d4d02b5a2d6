"""The control of the correctness check: the plain reference put in the
program's place one precision step down, which the check has to find
not correct.

The configurations state exact arithmetic over GF(257), whose symbols
take nine bits (0 to 256).  The step that tempts is to hold symbols in
a byte.  The control registers a GF backend in the program's dispatch
registry whose three primitives are the reference's (``reference.py``)
with every result held in 8 bits (256 wraps to 0), and runs the cell
with the store pinned to it: the whole timed path runs, only the field
arithmetic is the control's.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3

prints one line per seed with the check's numbers; each must come out
not correct.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = "perfbench-u8"
SYMBOL_BITS = 8


def register() -> str:
    """Register the control backend (once) and return its name."""
    import torch
    from repro_torch.kernels import dispatch

    from perfbench import reference as ref

    if NAME in dispatch.registered_backends():
        return NAME

    def place(res, out):
        if out is None:
            return res
        out.copy_(res)
        return out

    def matmul(a, b, p, out=None):
        if isinstance(b, (tuple, list)):
            b = torch.cat(list(b), dim=-2)
        return place(ref.gf_matmul(a, b, p, SYMBOL_BITS), out)

    def circulant_encode(data, c, p, out=None):
        return place(ref.encode(data, c, p, SYMBOL_BITS), out)

    def axpy(y, alpha, x, p):
        res = torch.remainder(y.to(torch.int64) + int(alpha)
                              * x.to(torch.int64), p)
        return (res & ((1 << SYMBOL_BITS) - 1)).to(torch.int32)

    dispatch.register(dispatch.GFBackend(
        name=NAME, matmul=matmul, circulant_encode=circulant_encode,
        axpy=axpy))
    return NAME


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run a cell with the control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    bench = harness.load_benchmark()
    backend = register()
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, t_start=time.perf_counter(),
                               backend=backend)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
