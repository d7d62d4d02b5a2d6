"""The one traffic generator.  A traffic mix is a JSON file of parameters
under ``perfbench/traffic/``: ``driver`` names the loop that sends it
(``perfbench/drivers/<driver>.py``, which documents its parameters), and
this module turns the parameters and a seed into the operations.

* closed-loop repair: the order in which nodes fail (``node_order``);
* closed-loop ingest: which key gets which payload (``ingest_plan``);
* open loops: ``rate_per_s`` Poisson arrivals, ``read_share`` of them
  reads and the rest updates, keys from YCSB's scrambled zipfian with
  ``zipfian_constant`` (``open_schedule``).

Every seed gets the same work in another order: the keys requested, the
split of reads and updates and the gaps between arrivals are fixed
multisets (quantiles of their distributions) that the seed shuffles.
Objects' contents and the orders come from the seed.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

# independent random streams of one seed
STREAM_OBJECTS, STREAM_NODES, STREAM_ARRIVALS, STREAM_OPS, STREAM_KEYS, \
    STREAM_UPDATES = range(6)

FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211


def load_mix(name: str) -> dict:
    mix = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json holds mix "
                         f"{mix.get('name')!r}")
    return mix


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def payload(gen: np.random.Generator, size: int) -> bytes:
    return gen.bytes(int(size))


def node_order(n_nodes: int, seed: int) -> list[int]:
    """All physical nodes (1-indexed) in an order drawn from the seed:
    the order closed-loop repair fails them in."""
    return [int(x) + 1 for x in rng(seed, STREAM_NODES).permutation(n_nodes)]


def fnv1a64(value: int) -> int:
    """YCSB's ``Utils.fnvhash64``: FNV-1a over the 8 bytes of a long,
    low byte first, as a non-negative Java long."""
    h = FNV_OFFSET_BASIS_64
    for _ in range(8):
        h ^= value & 0xFF
        h = (h * FNV_PRIME_64) & 0xFFFFFFFFFFFFFFFF
        value >>= 8
    if h >= 1 << 63:                  # Java's Math.abs of a signed long
        h = (1 << 64) - h
    return h


def zipf_keys(n_items: int, theta: float, m: int) -> np.ndarray:
    """``m`` key indexes with YCSB's scrambled zipfian popularity over
    ``n_items`` keys: the quantiles (i + 1/2) / m of a zipfian rank
    (P(rank r) ~ 1 / (r + 1) ** theta), each rank scrambled to a key by
    ``fnv1a64(rank) % n_items``.  Sorted by rank; shuffle to use."""
    w = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** theta
    cdf = np.cumsum(w) / w.sum()
    ranks = np.searchsorted(cdf, (np.arange(m) + 0.5) / m)
    return np.array([fnv1a64(int(r)) % n_items for r in ranks], np.int64)


@dataclasses.dataclass
class Op:
    due_s: float            # seconds after the window opened
    kind: str               # "get" or "put"
    key: int                # key index
    payload: int = -1       # index into the run's update payloads (puts)


def open_schedule(mix: dict, n_keys: int, seconds: float, seed: int,
                  stream_base: int = 0) -> list[Op]:
    """The operations due in a window of ``seconds``, in due order."""
    m = int(round(float(mix["rate_per_s"]) * seconds))
    if m < 1:
        return []
    # exponential gaps at the quantiles (i + 1/2) / m, scaled to fill
    # the window, in an order drawn from the seed
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m)
    gaps = gaps[rng(seed, stream_base + STREAM_ARRIVALS).permutation(m)]
    due = np.cumsum(gaps * (seconds / gaps.sum()))
    due -= due[0]
    n_put = int(round(m * (1.0 - float(mix["read_share"]))))
    kinds = np.array(["put"] * n_put + ["get"] * (m - n_put))
    kinds = kinds[rng(seed, stream_base + STREAM_OPS).permutation(m)]
    keys = zipf_keys(n_keys, float(mix["zipfian_constant"]), m)
    keys = keys[rng(seed, stream_base + STREAM_KEYS).permutation(m)]
    ops, n = [], 0
    for d, kind, key in zip(due, kinds, keys):
        ops.append(Op(float(d), str(kind), int(key),
                      n if kind == "put" else -1))
        n += kind == "put"
    return ops


def ingest_plan(n_keys: int, versions: int, i: int) -> tuple[int, int]:
    """(key, payload version) of the i-th closed-loop put after the fill
    (which put version v on key v): the least recently written key gets
    the next version in turn."""
    return i % n_keys, (n_keys + i) % versions


__all__ = ["load_mix", "rng", "payload", "node_order", "fnv1a64",
           "zipf_keys", "Op", "open_schedule", "ingest_plan",
           "STREAM_OBJECTS", "STREAM_UPDATES"]
