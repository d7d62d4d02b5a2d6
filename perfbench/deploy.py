"""The system under test, built from a configuration file: the port's
coded object store, with its repair scheduler and read front end, and
the objects the configuration stores.

A configuration is a JSON file under ``perfbench/configs/``.  Its
``code`` fixes the erasure code, ``store`` the deployment (nodes, racks,
stripe size) and ``frontend`` the read front end's service policy;
``objects`` says how many objects of which sizes the store holds.

``code["family"]`` is ``double-circulant`` (``k``, ``p`` and the
coefficients ``c``; n = 2k, d = k + 1) or ``product-matrix`` (``n``,
``k``, ``d``, ``p`` and the n + i evaluation points ``g``).  The store
is always built on a double-circulant class, its default; a
product-matrix configuration names its own class on every put
(``code_class``), and may state the default class's coefficients as
``default_c`` (otherwise the program searches for them, a few seconds
of set-up).  The
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
    if code["family"] == "double-circulant":
        c = code["c"]
    elif code["family"] == "product-matrix":
        c = code.get("default_c")
    else:
        raise ValueError(f"unknown code family {code['family']!r}")
    spec = CodeSpec.make(int(code["k"]), int(code["p"]), c=c)
    return CodedObjectStore(spec, n_nodes=int(st["n_nodes"]),
                            n_racks=st.get("n_racks"),
                            stripe_symbols=int(st["stripe_symbols"]),
                            device=device, backend=backend)


def code_class(cfg: dict):
    """The class each put names: None for the double-circulant family
    (the store's default, so a put is the call it always was), the
    product-matrix ``CodeClass`` otherwise."""
    code = cfg["code"]
    if code["family"] == "double-circulant":
        return None
    from repro_torch.codes import CodeClass
    return CodeClass(code["family"], int(code["n"]), int(code["k"]),
                     int(code["d"]), int(code["p"]))


def geometry(code: dict) -> dict:
    """n, d, the blocks a share holds and the data blocks a stripe
    carries, by family."""
    k = int(code["k"])
    if code["family"] == "double-circulant":
        return {"n": 2 * k, "d": k + 1, "share_blocks": 2,
                "data_blocks": 2 * k}
    if code["family"] == "product-matrix":
        alpha = int(code["d"]) - k + 1
        return {"n": int(code["n"]), "d": int(code["d"]),
                "share_blocks": alpha, "data_blocks": k * alpha}
    raise ValueError(f"unknown code family {code['family']!r}")


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


__all__ = ["load_config", "object_sizes", "build_store", "code_class",
           "geometry", "build_scheduler", "build_frontend"]
