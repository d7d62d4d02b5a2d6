"""Shape-bucketed execution-plan cache (the port of ``repro.exec.plan``).

The reference lowers each ``(op, static dims, bucket)`` key once to an
ahead-of-time XLA executable and pads every stream operand up to its
bucket on the geometric ladder of :func:`bucket_symbols`.  PyTorch runs
eagerly and the Hopper kernels mask the ragged edge of the stream
themselves, so the port needs neither the compile nor the padding.  It
keeps the reference's contract all the same:

* the same plan keys, with the same bucketing of the stream axis and of
  the batch axis of ``regenerate_batch``;
* the same hit / miss / compile accounting per key — here "compile" is
  the first successful launch of a key (on the card: the first use of the
  kernel configuration it names), so :func:`plan_stats` still proves the
  steady-state guarantee of zero new compiles after warm-up;
* asynchronous results: a :class:`PlanResult` holds the device tensor,
  and ``host()`` waits for that op alone — an event recorded right after
  it — and copies the result to the host on a side stream, so a
  pipeline's window t lands while window t+1's kernel is still queued
  behind it; it returns exactly the reference's numpy array, in pageable
  memory as the reference's is.

Host numpy operands reach a CUDA device through the planner's pinned
:class:`~repro_torch.exec.staging.StagingPool`: staged, copied with a
non-blocking DMA, and released once the copy's event has completed (at
the latest in ``host()``).  An operand that already IS a buffer of that
pool (caller-staged: the object store writes its windows straight into
``planner.staging`` buffers sized by :meth:`PlanCache.stream_pad`) is
DMA'd as it lies, with no second copy; its release stays with the
caller, after ``host()``.  Tensor operands already on the device are
used in place.

Mesh-sharded plans are not ported yet: ``mesh`` accepts only None or 1.
"""
from __future__ import annotations

import contextlib
import math
import threading
from time import perf_counter
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import as_int32, resolve_device

from .staging import StagingPool, record_stage

# Ladder defaults, identical to the reference: buckets 4096, 8192, ...
BUCKET_MIN = 1 << 12
BUCKET_RATIO = 2.0

# Batch axes (regenerate_batch's F) get a finer floor.
BATCH_BUCKET_MIN = 4

_ENABLED = True
_LOCK = threading.Lock()
_REGISTRY: dict[tuple, "PlanCache"] = {}


def bucket_symbols(s: int, *, bucket_min: int = BUCKET_MIN,
                   ratio: float = BUCKET_RATIO) -> int:
    """Smallest ladder bucket >= ``s``: bucket_min * ratio^j, j >= 0.

    >>> bucket_symbols(1000)
    4096
    >>> bucket_symbols(4097)
    8192
    """
    if s <= 0:
        raise ValueError(f"stream extent must be positive, got {s}")
    if ratio <= 1.0:
        raise ValueError(f"ladder ratio must be > 1, got {ratio}")
    if s <= bucket_min:
        return bucket_min
    # ceil in log space, then walk down float error
    j = max(0, math.ceil(math.log(s / bucket_min) / math.log(ratio)))
    b = int(math.ceil(bucket_min * ratio ** j))
    while b < s:                                   # float round-down guard
        j += 1
        b = int(math.ceil(bucket_min * ratio ** j))
    while j > 0 and int(math.ceil(bucket_min * ratio ** (j - 1))) >= s:
        j -= 1
        b = int(math.ceil(bucket_min * ratio ** j))
    return b


def set_planning(enabled: bool) -> None:
    """Process-wide switch: False bypasses every plan cache."""
    global _ENABLED
    _ENABLED = bool(enabled)


def planning_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def planning_disabled():
    """Temporarily bypass every plan cache."""
    prev = _ENABLED
    set_planning(False)
    try:
        yield
    finally:
        set_planning(prev)


def make_regen_fn(mm: Callable, p: int) -> Callable:
    """The fused newcomer compute, the single definition both execution
    modes run (planned ops here, the eager paths in ``core/repair.py``).

    One launch of the full (2, k+1) repair matrix R over the row sources
    ``(r_prev, next_data)`` — for a single node (1, S) and (k, S), for a
    batch (F, 1, S) and (F, k, S) against the shared R — so the r_prev row
    is read where it lies and nothing runs after the matmul.  The reference
    peels R's column 0 out into a row-0 scale-accumulate epilogue after a
    (2, k) matmul; the result is the same bit for bit, because GF(p)
    arithmetic is exact — both compute R @ [r_prev; next_data] mod p — and
    R[1, 0] = 0, so the r_prev column adds nothing to the re-encode row.
    ``mm`` must take the tuple form of its contraction operand (both
    dispatch backends do).
    """
    def fn(rmat, r_prev, next_data):
        return mm(rmat, (r_prev.unsqueeze(-2), next_data), p)

    return fn


class PlanStats(NamedTuple):
    """Plan-cache accounting: ``misses`` trigger ``compiles`` (they differ
    only if a first launch raises), ``hits`` reuse a planned key."""
    hits: int
    misses: int
    compiles: int


class PlanResult:
    """A planned op's asynchronous result: the device tensor plus the true
    stream extent (and batch, when the op bucketed a batch axis).

    Holding a PlanResult does not wait for the device.  :meth:`host`
    waits for this op only, copies to the host and trims to the true
    extents.
    """

    __slots__ = ("raw", "symbols", "batch", "_release", "_done")

    def __init__(self, raw, symbols: int, batch: Optional[int] = None,
                 release: Optional[Callable] = None, done=None):
        self.raw = raw
        self.symbols = int(symbols)
        self.batch = None if batch is None else int(batch)
        self._release = release
        self._done = done           # CUDA event recorded right after the op

    def host(self) -> np.ndarray:
        """Block and return the exact result as numpy.  Also the release
        point of any staging buffer the op's host-to-device copy read."""
        raw = self.raw
        if isinstance(raw, torch.Tensor):
            out = _to_host(raw, self._done) if raw.is_cuda \
                else raw.numpy()
        else:
            out = np.asarray(raw)
        if self._release is not None:
            rel, self._release = self._release, None
            rel()
        if out.shape[-1] != self.symbols:
            out = out[..., : self.symbols]
        if self.batch is not None and out.shape[0] != self.batch:
            out = out[: self.batch]
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.host()
        return out if dtype is None else out.astype(dtype)


_SIDE: dict = {}                    # device index -> device-to-host stream


def _to_host(raw: torch.Tensor, done) -> np.ndarray:
    """``raw`` copied into a fresh pageable numpy array on the device's
    side stream, after ``done`` (the op's own event; None records one now
    on the current stream).  Waits for that copy alone: work queued on
    the current stream after the op does not delay it.  Pageable, as the
    reference's results are: callers keep views of a result as stored
    shares, and page-locked memory would stay locked for their lifetime."""
    dev = raw.device
    if done is None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    with _LOCK:
        side = _SIDE.get(dev.index)
        if side is None:
            side = _SIDE[dev.index] = torch.cuda.Stream(dev)
    out = torch.empty(raw.shape, dtype=raw.dtype)
    with torch.cuda.stream(side):
        side.wait_event(done)
        raw.record_stream(side)     # the allocator may not reuse it early
        out.copy_(raw)              # blocks on the side stream only
    return out.numpy()


class PlanCache:
    """Shape-bucketed plan keys and accounting for one (backend, p, device).

    Parameters
    ----------
    backend : repro_torch.kernels.dispatch.GFBackend
        The exact GF implementation every planned op runs through.
    p : int
        Field modulus.
    bucket_min, bucket_ratio :
        The stream-axis ladder (:func:`bucket_symbols`).
    mesh : None or 1
        Stream-axis sharding is not ported yet; anything else raises.
    device : torch.device or str, optional
        Where the ops run; None is the card.
    """

    def __init__(self, backend, p: int, *, bucket_min: int = BUCKET_MIN,
                 bucket_ratio: float = BUCKET_RATIO, mesh=None, device=None):
        _check_mesh(mesh)
        self.backend = backend
        self.p = int(p)
        self.bucket_min = int(bucket_min)
        self.bucket_ratio = float(bucket_ratio)
        self.device = resolve_device(device)
        # pinned host staging for numpy operands bound for the card
        self.staging = StagingPool(pin=self.device.type == "cuda")
        self._plans: set[tuple] = set()
        self._lock = threading.Lock()
        # operands DMA'd straight out of caller-staged pool buffers
        self.staged_in_place = 0
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.family_stats: dict[str, list[int]] = {}

    # ------------------------------------------------------------- plumbing
    def bucket(self, s: int) -> int:
        return bucket_symbols(s, bucket_min=self.bucket_min,
                              ratio=self.bucket_ratio)

    def batch_bucket(self, f: int) -> int:
        return bucket_symbols(f, bucket_min=BATCH_BUCKET_MIN,
                              ratio=self.bucket_ratio)

    def _run(self, key: tuple, op: Callable[[], torch.Tensor],
             tag: Optional[str] = None) -> torch.Tensor:
        """Run ``op`` under plan ``key``: a hit if the key has launched
        before, else a miss whose successful launch counts as its compile."""
        fam = tag or "default"
        with self._lock:
            row = self.family_stats.setdefault(fam, [0, 0, 0])
            hit = key in self._plans
            if hit:
                self.hits += 1
                row[0] += 1
            else:
                self.misses += 1
                row[1] += 1
        out = op()
        if not hit:
            with self._lock:
                if key not in self._plans:
                    self._plans.add(key)
                    self.compiles += 1
                    row[2] += 1
        return out

    def stream_pad(self, s: int) -> tuple[int, int]:
        """(plan-key bucket, staging extent) for a true stream extent s.

        The reference pads a caller's staging buffer up to the bucket; the
        kernels here mask the ragged edge, so the buffer is exactly ``s``
        wide and no zero tail is ever computed."""
        return self.bucket(s), int(s)

    def _stage(self, x, bufs: list) -> torch.Tensor:
        """An int32 tensor of ``x`` on the planner's device.  Numpy bound
        for the card goes through a pinned pool buffer (appended to
        ``bufs``) and a non-blocking copy — unless it already is one of
        this pool's buffers, which is copied as it lies and stays the
        caller's to release."""
        if isinstance(x, torch.Tensor) or self.device.type != "cuda":
            return as_int32(x, self.p, self.device)
        arr = np.asarray(x)
        if arr.dtype == np.int32 and arr.flags.c_contiguous \
                and self.staging.holds(arr):
            self.staged_in_place += 1
            t0 = perf_counter()
            out = torch.from_numpy(arr).to(self.device, non_blocking=True)
            record_stage("h2d", perf_counter() - t0)
            return out
        if arr.dtype != np.int32 and arr.dtype.itemsize > 2:
            arr = np.remainder(arr.astype(np.int64), self.p)
        t0 = perf_counter()
        buf = self.staging.acquire(arr.shape, np.int32)
        np.copyto(buf, arr, casting="unsafe")
        out = torch.from_numpy(buf).to(self.device, non_blocking=True)
        bufs.append(buf)
        record_stage("h2d", perf_counter() - t0)
        return out

    def _result(self, raw: torch.Tensor, s: int, bufs: list,
                batch: Optional[int] = None) -> PlanResult:
        """Wrap ``raw`` with an event recorded right after the op (on the
        card); staged buffers are released once that event has completed,
        at the latest in host()."""
        if not raw.is_cuda:
            return PlanResult(raw, s, batch)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(raw.device))
        if not bufs:
            return PlanResult(raw, s, batch, done=ev)
        pool = self.staging

        def rel():
            ev.synchronize()
            for b in bufs:
                pool.release(b)

        return PlanResult(raw, s, batch, release=rel, done=ev)

    @staticmethod
    def _tagged(key: tuple, tag: Optional[str]) -> tuple:
        return key if tag is None else key + (tag,)

    def plan_stats(self) -> PlanStats:
        return PlanStats(self.hits, self.misses, self.compiles)

    def plan_stats_by_family(self) -> dict[str, PlanStats]:
        with self._lock:
            return {fam: PlanStats(*row)
                    for fam, row in sorted(self.family_stats.items())}

    def reset_stats(self) -> None:
        self.hits = self.misses = self.compiles = 0
        self.family_stats = {}

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
        self.reset_stats()

    def __len__(self) -> int:
        return len(self._plans)

    # ------------------------------------------------------------------ ops
    def matmul(self, mat, blocks, *, tag: Optional[str] = None) -> PlanResult:
        """(mat @ blocks) mod p — the decode-side workhorse.  ``mat``'s
        shape is part of the plan key, its values are not."""
        bufs: list = []
        mat = as_int32(mat, self.p, self.device)
        blocks = self._stage(blocks, bufs)
        s = blocks.shape[-1]
        if not _ENABLED:
            return self._result(self.backend.matmul(mat, blocks, self.p), s,
                                bufs)
        key = self._tagged(("matmul", tuple(mat.shape),
                            tuple(blocks.shape[:-1]), self.bucket(s)), tag)
        raw = self._run(key, lambda: self.backend.matmul(mat, blocks, self.p),
                        tag)
        return self._result(raw, s, bufs)

    def circulant_encode(self, data, c, *, tag: Optional[str] = None,
                         ) -> PlanResult:
        """The paper's eq. (2) encode; the coefficient tuple is part of the
        plan key."""
        bufs: list = []
        data = self._stage(data, bufs)
        c = tuple(int(x) for x in c)
        s = data.shape[-1]
        if not _ENABLED:
            return self._result(
                self.backend.circulant_encode(data, c, self.p), s, bufs)
        key = self._tagged(("circ", data.shape[0], c, self.bucket(s)), tag)
        raw = self._run(
            key, lambda: self.backend.circulant_encode(data, c, self.p), tag)
        return self._result(raw, s, bufs)

    def regenerate(self, rmat, r_prev, next_data) -> PlanResult:
        """The fused (2, k+1) repair-matrix application: one matmul launch
        over the row sources (r_prev, next_data), one plan per (k,
        bucket)."""
        bufs: list = []
        rmat = as_int32(rmat, self.p, self.device)
        r_prev = self._stage(r_prev, bufs)
        next_data = self._stage(next_data, bufs)
        s = r_prev.shape[-1]
        fn = self._regen_fn()
        if not _ENABLED:
            return self._result(fn(rmat, r_prev, next_data), s, bufs)
        key = ("regen", next_data.shape[0], self.bucket(s))
        raw = self._run(key, lambda: fn(rmat, r_prev, next_data))
        return self._result(raw, s, bufs)

    def regenerate_batch(self, rmat, r_prevs, next_data) -> PlanResult:
        """Batched fused regeneration — one matmul launch for all F failed
        nodes.  Both variable axes are bucketed in the plan key (stream on
        the symbol ladder, F on the batch ladder); ``host()`` returns the
        exact (F, 2, S) stack."""
        bufs: list = []
        rmat = as_int32(rmat, self.p, self.device)
        r_prevs = self._stage(r_prevs, bufs)
        next_data = self._stage(next_data, bufs)
        s = r_prevs.shape[-1]
        f, k = next_data.shape[0], next_data.shape[1]
        fn = self._regen_fn()
        if not _ENABLED:
            return self._result(fn(rmat, r_prevs, next_data), s, bufs,
                                batch=f)
        key = ("regen_batch", self.batch_bucket(f), k, self.bucket(s))
        raw = self._run(key, lambda: fn(rmat, r_prevs, next_data))
        return self._result(raw, s, bufs, batch=f)

    def matmul_batch(self, mats, blocks, *,
                     tag: Optional[str] = None) -> PlanResult:
        """Per-element batched (q, d) @ (d, S) mod p — the coalesced
        regeneration for families without a node-invariant repair matrix
        (product-matrix MSR): one launch with one matrix per element.

        mats: (F, q, d); blocks: (F, d, S).  Both the batch and the stream
        axis are bucketed in the plan key; ``host()`` returns the exact
        (F, q, S) stack."""
        ms, bs = np.shape(mats), np.shape(blocks)
        if len(ms) != 3 or len(bs) != 3 or ms[0] != bs[0] or ms[2] != bs[1]:
            raise ValueError(f"matmul_batch needs (F, q, d) mats and "
                             f"(F, d, S) blocks, got {tuple(ms)} / "
                             f"{tuple(bs)}")
        bufs: list = []
        mats = as_int32(mats, self.p, self.device)
        blocks = self._stage(blocks, bufs)
        f, s = bs[0], bs[-1]
        if not _ENABLED:
            return self._result(self.backend.matmul(mats, blocks, self.p),
                                s, bufs, batch=f)
        key = self._tagged(("matmul_batch", tuple(mats.shape[1:]),
                            self.batch_bucket(f), self.bucket(s)), tag)
        raw = self._run(key, lambda: self.backend.matmul(mats, blocks,
                                                         self.p), tag)
        return self._result(raw, s, bufs, batch=f)

    def _regen_fn(self):
        return make_regen_fn(self.backend.matmul, self.p)


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh != 1:
        raise NotImplementedError(
            "stream-axis mesh sharding is not ported yet; pass mesh=None "
            "(or 1)")


# --------------------------------------------------------------- registry
def get_planner(backend, p: int, *, bucket_min: int = BUCKET_MIN,
                bucket_ratio: float = BUCKET_RATIO, mesh=None,
                device=None) -> PlanCache:
    """The shared PlanCache for (backend, p, ladder, device): every code
    and engine on the same backend and device shares one plan cache."""
    _check_mesh(mesh)
    dev = resolve_device(device)
    key = (getattr(backend, "name", id(backend)), int(p), int(bucket_min),
           float(bucket_ratio), str(dev))
    with _LOCK:
        pc = _REGISTRY.get(key)
        if pc is None:
            pc = PlanCache(backend, p, bucket_min=bucket_min,
                           bucket_ratio=bucket_ratio, device=dev)
            _REGISTRY[key] = pc
        return pc


def plan_stats() -> PlanStats:
    """Aggregate hits/misses/compiles over every live planner."""
    h = m = c = 0
    with _LOCK:
        planners = list(_REGISTRY.values())
    for pc in planners:
        st = pc.plan_stats()
        h += st.hits
        m += st.misses
        c += st.compiles
    return PlanStats(h, m, c)


def plan_stats_by_family() -> dict[str, PlanStats]:
    """Per-family hit/miss/compile counters over every live planner."""
    agg: dict[str, list[int]] = {}
    with _LOCK:
        planners = list(_REGISTRY.values())
    for pc in planners:
        for fam, st in pc.plan_stats_by_family().items():
            row = agg.setdefault(fam, [0, 0, 0])
            row[0] += st.hits
            row[1] += st.misses
            row[2] += st.compiles
    return {fam: PlanStats(*row) for fam, row in sorted(agg.items())}


def reset_plan_stats() -> None:
    with _LOCK:
        planners = list(_REGISTRY.values())
    for pc in planners:
        pc.reset_stats()


def clear_planners() -> None:
    """Drop every plan key AND registry entry (tests only)."""
    with _LOCK:
        for pc in _REGISTRY.values():
            pc.clear()
        _REGISTRY.clear()


__all__ = [
    "BUCKET_MIN", "BUCKET_RATIO", "BATCH_BUCKET_MIN",
    "bucket_symbols", "make_regen_fn",
    "PlanCache", "PlanResult", "PlanStats",
    "get_planner", "plan_stats", "plan_stats_by_family",
    "reset_plan_stats", "clear_planners",
    "set_planning", "planning_enabled", "planning_disabled",
]
