"""One run of one cell: set-up, the measured window, the reference check
and the result line.  ``run.py`` is the command; the tests drive
:func:`run_cell` on the CPU.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration (``configs/<name>.json``, built by ``deploy.py``) under a
traffic mix (``traffic/<name>.json``).  Nothing here names a cell or a
kind of traffic: the mix names its driver, ``drivers/<driver>.py``, and
holds its parameters; what a run reports follows from
``BENCHMARK.json``, each metric read by ``metrics/<name>.py``.  A new
kind of traffic is a new driver file.

Set-up builds the store, and the driver makes the objects from the seed,
fills the store through the program's own ``put`` and warms every path
the window takes.  The window runs the driver for ``seconds``; a closed
loop closes with the operation that crosses the deadline, so a rate is
all the work over all the time.  After the window: the device's memory peak
is read, outstanding work is finished (up to a minute), the program's
outputs are compared with the reference, and the line is printed.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

from . import deploy, profile_reduce, traffic_gen, verify
from .profile_reduce import span

ROOT = Path(__file__).resolve().parents[1]
METRICS_DIR = Path(__file__).resolve().parent / "metrics"
DRIVERS_DIR = Path(__file__).resolve().parent / "drivers"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> Optional[str]:
    for c in bench["configs"]:
        if c["name"] == name:
            return str(ROOT / c["file"])
    return None


@dataclasses.dataclass
class Record:
    """What a run measured: the metric readers' input."""
    cell: str
    code: dict                     # k, n, p, S, family, d, share_blocks
                                   # and data_blocks of the configuration
    card: str = ""
    setup_s: float = 0.0
    window_s: float = 0.0
    puts: int = 0
    put_bytes: int = 0
    put_stripes: int = 0
    rebuilt_shares: int = 0        # shares rebuilt inside the window
    drain: dict = dataclasses.field(default_factory=dict)
    read_ms: list = dataclasses.field(default_factory=list)  # None: failed
    wait_ms: list = dataclasses.field(default_factory=list)
    pump_s: float = 0.0
    reads_served: int = 0
    decode_stripes: int = 0
    decode_blocks: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None


class Cell:
    """A configuration under a traffic mix, driven for one run.  What the
    run does follows from the mix's ``driver``: ``drivers/<driver>.py``
    fills the store and warms up (``setup``), drives the window
    (``window``) and may finish outstanding work (``finish``) and add
    numbers to the check (``check``)."""

    def __init__(self, name: str, cfg: dict, mix: dict, seed: int,
                 seconds: float, *, device=None,
                 backend: Optional[str] = None, trace: bool = False):
        self.name, self.cfg, self.mix, self.seed = name, cfg, mix, int(seed)
        self.seconds = float(seconds)
        self.device, self.backend, self.trace = device, backend, trace
        self.driver = load_driver(mix["driver"])
        code = cfg["code"]
        geo = deploy.geometry(code)
        self.k, self.n = int(code["k"]), geo["n"]
        self.data_blocks = geo["data_blocks"]
        self.code_class = deploy.code_class(cfg)
        self.s = int(cfg["store"]["stripe_symbols"])
        self.n_nodes = int(cfg["store"]["n_nodes"])
        self.rec = Record(cell=name, code={"k": self.k, "p": int(code["p"]),
                                           "S": self.s,
                                           "family": code["family"], **geo})
        self.keys = [f"obj{i:04d}" for i in range(int(cfg["objects"]
                                                      ["count"]))]
        self.sizes = deploy.object_sizes(cfg)
        self.lost: set[int] = set()        # nodes down at the check
        self.rebuilt: set[int] = set()     # nodes a repair rebuilt
        self.attempted = self.failed = 0
        self.store = self.ledger = None

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        if self.backend is not None:
            # the store pins its default class's code; the program builds
            # a put's own class (product-matrix) on the process's default
            from repro_torch.kernels import dispatch
            dispatch.set_default_backend(self.backend)
        self.store = deploy.build_store(self.cfg, device=self.device,
                                        backend=self.backend)
        self.ledger = verify.Ledger(self.n, self.s, self.store.placement_of,
                                    data_blocks=self.data_blocks)
        self.driver.setup(self)
        self.sync()

    def sync(self) -> None:
        import torch
        if torch.cuda.is_available() and self.device != "cpu":
            torch.cuda.synchronize()

    def fill(self, payloads: Optional[list] = None) -> None:
        """Put every key once: ``payloads`` by key index, or payloads of
        the keys' sizes made from the seed."""
        if payloads is None:
            gen = traffic_gen.rng(self.seed, traffic_gen.STREAM_OBJECTS)
            payloads = [traffic_gen.payload(gen, size) for size in self.sizes]
        for key, payload in zip(self.keys, payloads):
            self.put(key, payload, 0)

    def put(self, key: str, payload: bytes, version: int) -> bool:
        """The program's ``put``, naming the configuration's class where
        it is not the store's default; the ledger records it if it
        returned."""
        try:
            if self.code_class is None:
                self.store.put(key, payload)
            else:
                self.store.put(key, payload, code_class=self.code_class)
        except Exception as e:              # the run goes on; counted
            print(f"put {key} failed: {e!r}", file=sys.stderr)
            return False
        self.ledger.put(key, payload, version)
        return True

    def fail_replace(self, node: int) -> int:
        """Fail and replace ``node``; return the shares it lost."""
        with span("fail_replace", self.trace):
            self.store.fail_node(node)
            self.store.replace_node(node)
        self.rebuilt.add(node)
        return len(self.ledger.shares_on(node))

    # ----------------------------------------------------------- window
    def window(self) -> None:
        from repro_torch.exec import plan
        self.store.pipeline.reset_stage_stats()
        st0 = plan.plan_stats()
        prof = None
        if self.trace:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device != "cpu":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            with span("window", self.trace):
                t0 = time.perf_counter()
                self.driver.window(self, t0, self.seconds)
                self.sync()
                self.rec.window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        st1 = plan.plan_stats()
        self.rec.counters["plan"] = {
            "hits": st1.hits - st0.hits, "misses": st1.misses - st0.misses,
            "compiles": st1.compiles - st0.compiles}
        self.rec.counters["stage"] = self.store.pipeline.stage_stats()
        if prof is not None:
            self.rec.trace = profile_reduce.reduce(prof)

    # ------------------------------------------------------------ close
    def finish(self) -> None:
        """After the window: the driver finishes outstanding work."""
        if hasattr(self.driver, "finish"):
            self.driver.finish(self)

    def check(self) -> dict:
        out = verify.check_store(self.store, self.ledger, self.cfg["code"],
                                 lost=self.lost, rebuilt=self.rebuilt,
                                 device=self.ref_device())
        if hasattr(self.driver, "check"):
            out.update(self.driver.check(self))
        return out

    def ref_device(self):
        import torch
        return "cpu" if self.device == "cpu" or not \
            torch.cuda.is_available() else "cuda"

    def close(self) -> None:
        if hasattr(self.driver, "close"):
            self.driver.close(self)
        if self.store is not None:
            self.store.close()
        if self.backend is not None:
            from repro_torch.kernels import dispatch
            dispatch.set_default_backend(None)


# ------------------------------------------------------------------ drivers
def _load(path: Path, modname: str):
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    """The driver module ``drivers/<name>.py`` a mix names."""
    return _load(DRIVERS_DIR / f"{name}.py", f"perfbench.drivers.{name}")


# ------------------------------------------------------------------ metrics
def load_reader(name: str):
    """The reader ``metrics/<name>.py`` of a metric."""
    return _load(METRICS_DIR / f"{name}.py",
                 f"perfbench.metrics.{name}").read


def metric_specs(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metrics(specs: list[dict], rec: Record) -> dict:
    out = {}
    for m in specs:
        val = load_reader(m["name"])(rec)
        if val is not None:
            out[m["name"]] = {"value": val, "unit": m["unit"]}
    return out


# --------------------------------------------------------------------- run
def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device=None,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             backend: Optional[str] = None) -> dict:
    """One run; returns the result object (``checks`` last).
    ``config`` and ``mix`` replace the cell's files (the tests' small
    sizes); ``backend`` pins the program's GF backend (the control)."""
    import torch
    entry = cell_entry(bench, name)
    cfg = config or deploy.load_config(entry["config"],
                                       config_file(bench, entry["config"]))
    mix = mix or traffic_gen.load_mix(entry["traffic"])
    on_card = device != "cpu"
    cell = Cell(name, cfg, mix, seed, seconds, device=device,
                backend=backend, trace=trace)
    try:
        cell.setup()
        cell.rec.setup_s = time.perf_counter() - t_start
        cell.window()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        cell.finish()
        checks = cell.check()
    finally:
        cell.close()
    rec = cell.rec
    rec.card = torch.cuda.get_device_name(0) if on_card else "cpu"
    metrics = read_metrics(metric_specs(bench, name, trace), rec)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": rec.card,
           "count": int(entry["chips"]) if on_card else 0,
           "memory_peak_bytes": peak}
    checks["nothing_checked"] = int(checks["shares_checked"] < 1)
    limits = {k: v for k, v in verify.LIMITS.items() if k in checks}
    result = {"correct": all(checks[k] <= v for k, v in limits.items()),
              "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {
            "device_ops": profile_reduce.top(rec.trace["by_name"]),
            "idle_gaps": profile_reduce.top(rec.trace["idle_by_host"])}
    result["checks"] = {k: {"value": checks[k], "limit": v}
                        for k, v in limits.items()}
    return result


def main(args, *, t_start: float) -> int:
    import repro_torch  # noqa: F401  (the program under test must be here)
    import torch
    bench = load_benchmark()
    entry = cell_entry(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA card(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, float(args.seconds),
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


__all__ = ["Cell", "Record", "run_cell", "main", "metric_specs",
           "read_metrics", "load_benchmark", "load_driver", "load_reader",
           "forbidden_modules"]
