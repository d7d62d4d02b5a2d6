"""Fault injection for the I/O substrate (the port of ``repro.io.faults``,
DESIGN.md §12.4).

A :class:`FaultInjector` holds an ordered list of :class:`FaultSpec`
rules and a seeded RNG; seams consult it per operation:

* :class:`FaultyBlob` wraps any `repro_torch.io.blob.BlobBackend` and maps
  matched rules onto byte-level damage — **torn** writes (a prefix
  lands, then ``OSError``), **corrupt** reads/writes (a flipped byte),
  **transient** ``OSError``s, and per-path **latency**;
* the coded object store consults :meth:`FaultInjector.apply` around
  its share reads/writes with refs like ``node:03``, so per-node
  transient failures and latency inject without a filesystem in the
  loop.

Rules fire deterministically given the seed: probability draws consume
the injector RNG only for rules that are otherwise eligible, and
``times`` caps how often a rule fires — ``times=1`` is "exactly one
torn write, then the disk behaves", the retry-heals-a-torn-write drill.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from .blob import BlobBackend, PathLike


@dataclasses.dataclass
class FaultSpec:
    """One injection rule.

    op : "write" | "read" | "rename" | "*"
    match : substring of the operation ref (a path string or a store
        ``node:NN`` ref); "" matches everything.
    kind : "transient" (raise OSError) | "torn" (write/read a prefix)
         | "corrupt" (flip a byte) | "latency" (sleep, then proceed).
    times : fire at most this many times (None = unlimited).
    prob : per-eligible-op firing probability (seeded, deterministic).
    latency_s, torn_fraction : kind parameters.
    """
    op: str = "*"
    match: str = ""
    kind: str = "transient"
    times: Optional[int] = None
    prob: float = 1.0
    latency_s: float = 0.0
    torn_fraction: float = 0.5
    fired: int = 0

    KINDS = ("transient", "torn", "corrupt", "latency")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self.KINDS}")


class FaultInjector:
    """Seeded, thread-safe rule set the I/O seams consult per op."""

    def __init__(self, seed: int = 0, *,
                 sleep: Callable[[float], None] = time.sleep):
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self.specs: list[FaultSpec] = []
        self.fired_total = 0

    def add(self, **kw) -> FaultSpec:
        spec = FaultSpec(**kw)
        self.specs.append(spec)
        return spec

    def clear(self) -> None:
        self.specs = []

    def match(self, op: str, ref: PathLike) -> Optional[FaultSpec]:
        """First eligible rule that fires for (op, ref), or None.  The
        probability draw is consumed only for eligible rules, so a run's
        fault sequence depends only on the seed and the op stream."""
        ref = str(ref)
        with self._lock:
            for spec in self.specs:
                if spec.op not in ("*", op):
                    continue
                if spec.match and spec.match not in ref:
                    continue
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                spec.fired += 1
                self.fired_total += 1
                return spec
        return None

    def apply(self, op: str, ref: PathLike) -> None:
        """Payload-free seam (store share ops): latency sleeps, anything
        else raises a transient ``OSError`` — torn/corrupt need a byte
        payload and only exist on the blob seam."""
        spec = self.match(op, ref)
        if spec is None:
            return
        if spec.kind == "latency":
            self._sleep(spec.latency_s)
            return
        raise OSError(f"injected {spec.kind} fault: {op} {ref}")

    def apply_share(self, op: str, ref: PathLike, share: list) -> list:
        """Share-payload seam (the store's read path, DESIGN.md §13.2):
        ``latency`` sleeps then returns the share untouched, ``corrupt``
        returns a DAMAGED COPY — one data symbol xor-flipped, backing
        storage intact — the read-path bit-rot an end-to-end checksum
        must catch, and anything else raises a transient ``OSError``.
        The caller's stored share list is never mutated."""
        spec = self.match(op, ref)
        if spec is None:
            return share
        if spec.kind == "latency":
            self._sleep(spec.latency_s)
            return share
        if spec.kind == "corrupt":
            node, a, r = share
            a = np.array(a, dtype=np.int32, copy=True)
            if a.size:
                with self._lock:
                    i = int(self._rng.integers(a.size))
                a[i] ^= 0x55        # stays < 256: still a valid data symbol
            return [node, a, r]
        raise OSError(f"injected {spec.kind} fault: {op} {ref}")


def _flip_byte(data: bytes, rng: np.random.Generator) -> bytes:
    if not data:
        return data
    i = int(rng.integers(len(data)))
    out = bytearray(data)
    out[i] ^= 0xFF
    return bytes(out)


class FaultyBlob(BlobBackend):
    """A BlobBackend wrapper that injects the matched damage.

    Write kinds: ``transient`` raises before any byte lands; ``torn``
    writes ``torn_fraction`` of the payload through the inner backend
    and THEN raises (the crash-mid-write shape the commit protocol must
    mask); ``corrupt`` silently writes a flipped byte; ``latency``
    sleeps then proceeds.  Read kinds mirror: torn returns a prefix,
    corrupt flips a byte in what was read.  ``rename``/``remove``/
    ``rmtree``/``mkdir`` support transient + latency via
    :meth:`FaultInjector.apply` (ref = destination path), so drills can
    kill the commit rename itself.
    """

    def __init__(self, inner: BlobBackend, faults: FaultInjector):
        self.inner = inner
        self.faults = faults
        self._rng = np.random.default_rng(0xC0FFEE)

    # ------------------------------------------------------------- payload ops
    def write(self, path: PathLike, data: bytes) -> None:
        spec = self.faults.match("write", path)
        if spec is not None:
            if spec.kind == "latency":
                self.faults._sleep(spec.latency_s)
            elif spec.kind == "transient":
                raise OSError(f"injected transient write fault: {path}")
            elif spec.kind == "torn":
                cut = int(len(data) * spec.torn_fraction)
                self.inner.write(path, data[:cut])
                raise OSError(f"injected torn write ({cut}/{len(data)} "
                              f"bytes): {path}")
            elif spec.kind == "corrupt":
                data = _flip_byte(data, self._rng)
        self.inner.write(path, data)

    def read(self, path: PathLike) -> bytes:
        spec = self.faults.match("read", path)
        if spec is not None:
            if spec.kind == "latency":
                self.faults._sleep(spec.latency_s)
            elif spec.kind == "transient":
                raise OSError(f"injected transient read fault: {path}")
            elif spec.kind == "torn":
                data = self.inner.read(path)
                return data[: int(len(data) * spec.torn_fraction)]
            elif spec.kind == "corrupt":
                return _flip_byte(self.inner.read(path), self._rng)
        return self.inner.read(path)

    # ---------------------------------------------------------- metadata ops
    def exists(self, path: PathLike) -> bool:
        return self.inner.exists(path)

    def isdir(self, path: PathLike) -> bool:
        return self.inner.isdir(path)

    def listdir(self, path: PathLike) -> list[str]:
        return self.inner.listdir(path)

    def mkdir(self, path: PathLike) -> None:
        self.faults.apply("mkdir", path)
        self.inner.mkdir(path)

    def rename(self, src: PathLike, dst: PathLike) -> None:
        self.faults.apply("rename", dst)
        self.inner.rename(src, dst)

    def remove(self, path: PathLike) -> None:
        self.faults.apply("remove", path)
        self.inner.remove(path)

    def rmtree(self, path: PathLike) -> None:
        self.faults.apply("rmtree", path)
        self.inner.rmtree(path)

    def fsync_dir(self, path: PathLike) -> None:
        self.inner.fsync_dir(path)


__all__ = ["FaultSpec", "FaultInjector", "FaultyBlob"]
