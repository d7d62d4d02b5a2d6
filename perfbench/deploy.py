"""The system under test, built from a configuration file: the port's
coded object store, with its repair scheduler and read front end, and
the objects the configuration stores.

A configuration is a JSON file under ``perfbench/configs/``.  Its
``code`` fixes the erasure code, ``store`` the deployment (nodes, racks,
stripe size) and ``frontend`` the read front end's service policy;
``objects`` says how many objects of which sizes the store holds.  The
program's tuning knobs (pipeline depth, tile widths, pool sizes) are
left at the program's defaults, so a change to a default is measured.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

CONFIG_DIR = Path(__file__).resolve().parent / "configs"


def load_config(name: str, path: str | None = None) -> dict:
    """The configuration ``name`` (its file, or ``configs/<name>.json``)."""
    p = Path(path) if path else CONFIG_DIR / f"{name}.json"
    cfg = json.loads(p.read_text())
    if cfg.get("name") != name:
        raise ValueError(f"{p} holds configuration {cfg.get('name')!r}, "
                         f"not {name!r}")
    return cfg


def object_sizes(cfg: dict) -> list[int]:
    """The byte size of each object, by key index.  The same for every
    seed: ``log_uniform`` takes the quantiles (i + 1/2) / count of the
    distribution and hands them to keys in a fixed shuffled order, so a
    seed changes contents and order, never the work."""
    obj = cfg["objects"]
    count = int(obj["count"])
    dist = obj["size_dist"]
    if dist == "fixed":
        return [int(obj["size_bytes"])] * count
    if dist == "log_uniform":
        lo, hi = math.log(obj["size_min"]), math.log(obj["size_max"])
        sizes = [int(round(math.exp(lo + (i + 0.5) / count * (hi - lo))))
                 for i in range(count)]
        order = np.random.default_rng(int(obj["assign_seed"])) \
            .permutation(count)
        return [sizes[int(i)] for i in order]
    raise ValueError(f"unknown size_dist {dist!r}")


def build_store(cfg: dict, *, device=None, backend: str | None = None):
    """A ``CodedObjectStore`` for the configuration (``device=None`` is
    the card; ``backend`` pins a GF backend by name)."""
    from repro_torch.core.circulant import CodeSpec
    from repro_torch.store import CodedObjectStore
    code, st = cfg["code"], cfg["store"]
    if code["family"] != "double-circulant":
        raise ValueError(f"unknown code family {code['family']!r}")
    spec = CodeSpec.make(int(code["k"]), int(code["p"]), c=code["c"])
    return CodedObjectStore(spec, n_nodes=int(st["n_nodes"]),
                            n_racks=st.get("n_racks"),
                            stripe_symbols=int(st["stripe_symbols"]),
                            device=device, backend=backend)


def build_scheduler(store):
    from repro_torch.store import RepairScheduler
    sched = RepairScheduler(store)
    store.subscribe(sched.on_event)
    return sched


def build_frontend(cfg: dict, store):
    from repro_torch.serve.frontend import ReadFrontEnd
    fe = cfg["frontend"]
    return ReadFrontEnd(store, default_deadline_s=float(fe["deadline_s"]),
                        hedge_after_s=fe["hedge_after_s"],
                        max_queue=int(fe["max_queue"]),
                        fetch_workers=int(fe["fetch_workers"]))


__all__ = ["load_config", "object_sizes", "build_store", "build_scheduler",
           "build_frontend"]
