"""Pooled host staging + per-stage wall-time accounting (the port of
``repro.exec.staging``).

:class:`StagingPool` is a reusable ring of host buffers on a power-of-two
size ladder.  With ``pin=True`` (the planner sets it when its device is
CUDA) every buffer is page-locked host memory from
``torch.empty(..., pin_memory=True)``, so a host-to-device copy out of it
is a true asynchronous DMA; with ``pin=False`` (CPU planners) buffers are
plain numpy.  Either way ``acquire`` hands out a numpy view.

**Aliasing rule** (unchanged from the reference): a buffer handed out by
``acquire`` is never handed out again until ``release`` is called on it,
and callers release only after the copy that read the buffer has
completed — an event recorded after the copy has been waited on, or the
blocking ``PlanResult.host()``.  Dropping a buffer without releasing it is
safe: it is retired, never reissued.

The module also owns the process-wide stage clock: ``record_stage`` /
``stage_times`` accumulate wall time per named stage ("pack" for the
byte/symbol packing, "h2d" for staging a host operand onto the device).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager
from time import perf_counter
from typing import NamedTuple

import numpy as np
import torch

# Pool buckets ride their own power-of-two ladder from this floor, which
# matches the plan cache's BUCKET_MIN.
POOL_BUCKET_MIN = 1 << 12

# Stage names of the reference's pipeline accounting, kept for parity.
STAGE_NAMES = ("t_stage_read", "t_pack", "t_pad", "t_dispatch",
               "t_consume")

# ------------------------------------------------------------ stage clock
_TLOCK = threading.Lock()
_TIMES: dict = defaultdict(float)
_CALLS: dict = defaultdict(int)


def record_stage(name: str, seconds: float) -> None:
    """Accumulate ``seconds`` of wall time under stage ``name``."""
    with _TLOCK:
        _TIMES[name] += float(seconds)
        _CALLS[name] += 1


def stage_times() -> dict:
    """Cumulative process-wide seconds per stage since the last reset."""
    with _TLOCK:
        return dict(_TIMES)


def stage_calls() -> dict:
    with _TLOCK:
        return dict(_CALLS)


def reset_stage_times() -> None:
    with _TLOCK:
        _TIMES.clear()
        _CALLS.clear()


@contextmanager
def staged(name: str):
    """Time a block under stage ``name``."""
    t0 = perf_counter()
    try:
        yield
    finally:
        record_stage(name, perf_counter() - t0)


# ------------------------------------------------------------------- pool
class StagingStats(NamedTuple):
    """``hits`` reused a pooled buffer, ``misses`` allocated a fresh one,
    ``in_use`` are acquired-but-unreleased buffers, ``pooled_bytes`` is
    the resident free-list footprint."""
    hits: int
    misses: int
    released: int
    in_use: int
    pooled_bytes: int


def _bucket_elems(elems: int) -> int:
    """Smallest power-of-two ladder size >= elems (floor POOL_BUCKET_MIN)."""
    b = POOL_BUCKET_MIN
    while b < elems:
        b <<= 1
    return b


class StagingPool:
    """A reusable ring of bucket-ladder-sized host staging buffers.

    Parameters
    ----------
    max_pooled : int
        Cap on retained free buffers per (dtype, bucket) slot.
    pin : bool
        Back every buffer with page-locked memory (needs CUDA).  Off, the
        buffers are numpy allocations touched once at allocation.
    """

    def __init__(self, max_pooled: int = 8, pin: bool = False):
        self.max_pooled = int(max_pooled)
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._free: dict = defaultdict(list)   # (dtype.str, bucket) -> entries
        self._in_use: dict = {}                # id(base) -> (key, entry)
        self.hits = 0
        self.misses = 0
        self.released = 0

    def _allocate(self, dt: np.dtype, elems: int):
        """(numpy base, owner) — owner keeps pinned memory alive."""
        if self.pin:
            owner = torch.empty(elems, dtype=torch.from_numpy(
                np.empty(0, dt)).dtype, pin_memory=True)
            return owner.numpy(), owner
        base = np.empty(elems, dt)
        base.fill(0)                    # touch every page once
        return base, None

    def acquire(self, shape, dtype=np.int32) -> np.ndarray:
        """A ``shape``-shaped numpy view into a pooled host buffer.
        Contents are undefined: callers overwrite what they use."""
        shape = tuple(int(x) for x in shape)
        dt = np.dtype(dtype)
        elems = 1
        for x in shape:
            elems *= x
        key = (dt.str, _bucket_elems(max(elems, 1)))
        with self._lock:
            free = self._free.get(key)
            entry = free.pop() if free else None
            if entry is not None:
                self.hits += 1
            else:
                self.misses += 1
        if entry is None:
            entry = self._allocate(dt, key[1])
        base = entry[0]
        with self._lock:
            self._in_use[id(base)] = (key, entry)
        return base[:elems].reshape(shape)

    @staticmethod
    def _base_of(arr: np.ndarray) -> np.ndarray:
        while arr.base is not None and isinstance(arr.base, np.ndarray):
            arr = arr.base
        return arr

    def holds(self, arr) -> bool:
        """True when ``arr`` is a view of a buffer this pool handed out and
        that is not yet released (a caller-staged operand)."""
        if not isinstance(arr, np.ndarray):
            return False
        with self._lock:
            return id(self._base_of(arr)) in self._in_use

    def release(self, arr) -> None:
        """Return ``arr``'s backing buffer to the pool.  Only call once the
        copy that read it has completed — the aliasing rule."""
        if not isinstance(arr, np.ndarray):
            return
        base = self._base_of(arr)
        with self._lock:
            found = self._in_use.pop(id(base), None)
            if found is None:
                return                  # foreign array / double release
            key, entry = found
            self.released += 1
            if len(self._free[key]) < self.max_pooled:
                self._free[key].append(entry)

    def stats(self) -> StagingStats:
        with self._lock:
            pooled = sum(e[0].nbytes for entries in self._free.values()
                         for e in entries)
            return StagingStats(self.hits, self.misses, self.released,
                                len(self._in_use), pooled)

    def clear(self) -> None:
        """Drop every retained buffer (tests / memory pressure)."""
        with self._lock:
            self._free.clear()
            self._in_use.clear()
            self.hits = self.misses = self.released = 0


__all__ = ["StagingPool", "StagingStats", "POOL_BUCKET_MIN", "STAGE_NAMES",
           "record_stage", "stage_times", "stage_calls",
           "reset_stage_times", "staged"]
