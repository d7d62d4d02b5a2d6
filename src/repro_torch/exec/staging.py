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

The module also owns the process-wide stage clock.  ``staged(name)`` is
the one way the program times a stage: it adds the block's wall seconds
and a call to stage ``name`` (``stage_times`` / ``stage_calls``).  The
stages: "pack" (byte/symbol packing), "h2d" (staging a host operand onto
the device), "land" (the checkpointer's landing copies), the store's
"chunk", "commit", "crc", "install", "gather" and the scheduler's
"select", the read front end's "fe_fetch" and "fe_decode" and its tick's
"tick_pump" and "tick_drain" (`repro_torch.serve.frontend`), and each
pipeline's "stage_read", "read_wait", "dispatch", "consume" and
"barrier" (`repro_torch.exec.pipeline`).  Per-share work inside a loop
runs under ``tallied(name)``, which sums the loop's ``staged(name)``
blocks on that thread and records them once, as one call; work shared
out over threads hands each task's or each thread's sum back
(``tallied(name, record=False)``) and one thread records the total.

``annotate(True)`` also opens every stage as a
``torch.profiler.record_function`` range named ``repro_torch.<stage>``,
so a trace taken under ``torch.profiler`` shows the stages on the host
timeline, on the clock its kernels and copies are aligned to.  It is
off by default: a range also leaves a mirror on the device timeline.
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

# Keys of ``Pipeline.stage_stats()``: a pipeline's own stages, summed per
# pipeline, then the clock's stages as deltas since the pipeline's reset.
PIPELINE_STAGES = ("t_stage_read", "t_read_wait", "t_dispatch",
                   "t_consume", "t_barrier")
CLOCK_STAGES = ("t_pack", "t_h2d", "t_chunk", "t_commit", "t_crc",
                "t_install", "t_select", "t_gather", "t_tick_pump",
                "t_tick_drain", "t_fe_fetch", "t_fe_decode")
STAGE_NAMES = PIPELINE_STAGES + CLOCK_STAGES

# Name prefix of a stage's profiler range when annotation is on.
RANGE_PREFIX = "repro_torch."

# ------------------------------------------------------------ stage clock
_TLOCK = threading.Lock()
_TIMES: dict = defaultdict(float)
_CALLS: dict = defaultdict(int)
_ANNOTATE = False
_LOCAL = threading.local()          # per thread: the open tallies


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


def annotate(on: bool) -> None:
    """Process-wide switch: with it on, every ``staged`` block is also a
    ``torch.profiler.record_function`` range ``repro_torch.<stage>``."""
    global _ANNOTATE
    _ANNOTATE = bool(on)


class Span:
    """What one ``staged`` block took: ``seconds``, set when it ends."""
    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


def _tallies() -> dict:
    tallies = getattr(_LOCAL, "tallies", None)
    if tallies is None:
        tallies = _LOCAL.tallies = {}
    return tallies


@contextmanager
def staged(name: str):
    """Time a block under stage ``name``: its seconds and a call go to
    the clock, or to this thread's open ``tallied(name)``.  Yields a
    :class:`Span` that holds the block's seconds once it has ended."""
    span = Span()
    rng = None
    if _ANNOTATE:
        rng = torch.profiler.record_function(RANGE_PREFIX + name)
        rng.__enter__()
    t0 = perf_counter()
    try:
        yield span
    finally:
        span.seconds = perf_counter() - t0
        if rng is not None:
            rng.__exit__(None, None, None)
        acc = _tallies().get(name)
        if acc is None:
            record_stage(name, span.seconds)
        else:
            acc[0] += span.seconds
            acc[1] += 1


@contextmanager
def tallied(name: str, record: bool = True):
    """Sum the ``staged(name)`` blocks this thread runs inside the block
    into the yielded ``[seconds, calls]`` and record them on the clock
    once, as one call, when it ends: a loop's per-share work costs one
    clock record.  A tally of a name already open on this thread joins
    it.  ``record=False`` hands the block's own sum back and records
    nothing (an open tally is set aside meanwhile): the caller records
    the total of work shared out over threads."""
    tallies = _tallies()
    outer = tallies.get(name)
    if outer is not None and record:
        yield outer
        return
    acc = tallies[name] = [0.0, 0]
    try:
        yield acc
    finally:
        if outer is None:
            del tallies[name]
        else:
            tallies[name] = outer
        if record and acc[1]:
            record_stage(name, acc[0])


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
           "PIPELINE_STAGES", "CLOCK_STAGES", "RANGE_PREFIX", "Span",
           "record_stage", "stage_times", "stage_calls",
           "reset_stage_times", "staged", "tallied", "annotate"]
