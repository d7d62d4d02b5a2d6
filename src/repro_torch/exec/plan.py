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

Mesh-sharded plans: pass ``mesh=`` (a
:class:`~repro_torch.sharding.mesh.StreamMesh`, an int shard count over
the CUDA cards, or None) and every op runs once per shard under the
rule registry (:func:`~repro_torch.sharding.mesh.shard_body`): the
stream splits into ``ceil(s / m)``-wide column windows, the small
matrices are replicated, and the result is assembled on the mesh's first
device.  An unsharded planner runs the same path over one shard on its
device.  The plan key buckets the *per-shard* extent, as the reference
does; hits, misses and compiles count per op call, not per shard.  A
1-shard mesh normalizes to the plain unsharded planner (the same
object), and donation is off when meshed.

Operands: a tensor already on a shard's device is read in place (the
kernels take a row pitch), and a shard on the result's device writes its
window of the output in place.  Host numpy is staged once per device:
the span of that device's windows is copied into a buffer of the
planner's pinned :class:`~repro_torch.exec.staging.StagingPool`, DMA'd
non-blocking, and released once the op's events have completed (at the
latest in ``host()``).  An operand that already IS a buffer of that pool
(caller-staged: the object store writes its windows straight into
``planner.staging`` buffers sized by :meth:`PlanCache.stream_pad`) and
whose span is the whole of it is DMA'd as it lies, with no second copy;
its release stays with the caller, after ``host()``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import as_int32, canonical_device, resolve_device
from repro_torch.sharding.mesh import (StreamMesh, as_stream_mesh,
                                       mesh_device, shard_body, window_to)

from .staging import StagingPool, staged

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
    dispatch backends do), and ``out=`` when one is passed (a meshed
    planner's shards write their windows of the result in place).
    """
    def fn(rmat, r_prev, next_data, out=None):
        b = (r_prev.unsqueeze(-2), next_data)
        return mm(rmat, b, p) if out is None else mm(rmat, b, p, out=out)

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
    # ``_done``: the op's event on raw's device; a sharded op's release
    # also waits for every shard device's event.

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

    def device(self) -> torch.Tensor:
        """The exact result as a tensor where the op ran, with no copy to
        the host: for callers whose next step computes on the device too.
        Also a release point of any staging buffer the op read (once the
        op's event has completed)."""
        if self._release is not None:
            rel, self._release = self._release, None
            rel()
        out = self.raw
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
    donate : bool, optional
        The reference's buffer-donation switch (None: on for a device
        backend, off on the CPU), accepted and recorded as ``.donate``.
        On the card it reuses nothing: torch has no buffer donation, every
        planned op reads its operands where the caller left them (or from
        the planner's own staging) and returns a fresh tensor, so a
        caller's operand is never overwritten and no result changes.
    mesh : StreamMesh | int | None, optional
        Shard every op over this stream-axis mesh (see the module
        docstring); a 1-shard mesh normalizes to None.  The backend's
        ops must then take ``out=``, as both registered backends do.
    device : torch.device or str, optional
        Where the ops run and results land; None is the card, or the
        mesh's first device when meshed (another device raises).
    """

    def __init__(self, backend, p: int, *, bucket_min: int = BUCKET_MIN,
                 bucket_ratio: float = BUCKET_RATIO,
                 donate: Optional[bool] = None, mesh=None, device=None):
        mesh, device = _normalize_mesh(mesh, device)
        self.backend = backend
        self.p = int(p)
        self.bucket_min = int(bucket_min)
        self.bucket_ratio = float(bucket_ratio)
        self.mesh = mesh
        self.device = resolve_device(device)
        # the shards every op runs over: one on the device when unsharded
        self._shards = mesh if mesh is not None else \
            StreamMesh(1, devices=[self.device])
        # no donation when meshed, as the reference: each shard reads
        # its own window, there is no whole buffer to reuse
        self.donate = False if mesh is not None else \
            _donation(donate, self.device)
        # pinned host staging for numpy operands bound for a card
        self.staging = StagingPool(pin=any(
            d.type == "cuda" for d in self._shards.devices))
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

        The reference pads a caller's staging buffer up to the bucket
        (per shard when meshed: the bucket of ``ceil(s / m)``); the
        kernels here mask the ragged edge, so the buffer is exactly ``s``
        wide and no zero tail is ever computed."""
        return self.bucket(self._shards.shard_extent(s)), int(s)

    def _result(self, raw: torch.Tensor, s: int, bufs: list,
                batch: Optional[int] = None) -> PlanResult:
        """Wrap ``raw`` with an event recorded right after the op (on the
        card), and after a sharded op one on every other shard device;
        staged buffers are released once those events have completed, at
        the latest in host()."""
        if not raw.is_cuda:
            # a result on the CPU was copied there synchronously: every
            # shard's reads of its staging are done
            for b in bufs:
                self.staging.release(b)
            return PlanResult(raw, s, batch)
        devs = [raw.device] + sorted(
            {d for d in self._shards.devices if d.type == "cuda"}
            - {raw.device}, key=str)
        events = []
        for d in devs:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
        if not bufs and len(events) == 1:
            return PlanResult(raw, s, batch, done=events[0])
        pool = self.staging

        def rel():
            for ev in events:
                ev.synchronize()
            for b in bufs:
                pool.release(b)

        return PlanResult(raw, s, batch, release=rel, done=events[0])

    # ------------------------------------------------------------- sharding
    def _prep(self, x):
        """A stream operand before it is split: a tensor as int32 where it
        lies; anything else as an integer numpy array (wide dtypes reduced
        mod p), staged device by device in :meth:`_stager`."""
        if isinstance(x, torch.Tensor):
            return as_int32(x, self.p, x.device)
        arr = np.asarray(x)
        if arr.dtype.kind not in "iu":
            raise TypeError(f"GF symbols must be integers, got {arr.dtype}")
        if arr.dtype != np.int32 and arr.dtype.itemsize > 2:
            arr = np.remainder(arr.astype(np.int64), self.p)
        return arr

    def _stager(self, bufs: list) -> Callable:
        """``shard_body``'s stage for one op: a tensor's window read in
        place on its own device (else copied there); a host array staged
        once per device — the span of that device's windows — and each
        window read from the staged span in place."""
        spans: dict = {}

        def stage(x, dim, lo, hi, dev):
            if isinstance(x, torch.Tensor):
                return window_to(x, dim, lo, hi, dev)
            key = (id(x), dev)
            if key not in spans:
                wins = [w for d, w in zip(self._shards.devices,
                                          self._shards.windows(x.shape[dim]))
                        if d == dev and w[1] > w[0]]
                a, b = wins[0][0], wins[-1][1]
                spans[key] = a, self._stage_span(x, dim, a, b, dev, bufs)
            a, t = spans[key]
            return t.narrow(dim, lo - a, hi - lo)

        return stage

    def _stage_span(self, arr: np.ndarray, dim: int, a: int, b: int,
                    dev: torch.device, bufs: list) -> torch.Tensor:
        """Columns [a, b) along ``dim`` of a prepared host array as an
        int32 tensor on ``dev``.  The host reads it where it lies.  A card
        gets a non-blocking DMA: of the array as it lies when the span is
        the whole of one of this pool's buffers (the caller's to
        release), else of a pooled pinned copy (appended to ``bufs``)."""
        span = arr if (a, b) == (0, arr.shape[dim]) else \
            arr[(slice(None),) * dim + (slice(a, b),)]
        if dev.type != "cuda":
            return as_int32(span, self.p, dev)
        with staged("h2d"):
            if span is arr and arr.dtype == np.int32 \
                    and arr.flags.c_contiguous and self.staging.holds(arr):
                self.staged_in_place += 1
                src = arr
            else:
                src = self.staging.acquire(span.shape, np.int32)
                np.copyto(src, span, casting="unsafe")
                bufs.append(src)
            return torch.from_numpy(src).to(dev, non_blocking=True)

    def _launch(self, op: str, fn: Callable, operands: tuple, out_shape: tuple,
                key: tuple, tag: Optional[str] = None,
                batch: Optional[int] = None) -> PlanResult:
        """Run ``fn`` once per shard under op's rule (one shard on the
        planner's device when unsharded), assembled into a new
        (out_shape) int32 tensor on the planner's device, under plan
        ``key``."""
        bufs: list = []

        def launch():
            out = torch.empty(out_shape, dtype=torch.int32,
                              device=self.device)
            run = shard_body(fn, op, self._shards, stage=self._stager(bufs))
            return run(*operands, out=out)

        s = out_shape[-1]
        if not _ENABLED:
            return self._result(launch(), s, bufs, batch)
        return self._result(self._run(key, launch, tag), s, bufs, batch)

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
        shape is part of the plan key, its values are not.  ``blocks`` may
        be a tuple of row sources read as if concatenated along the
        contraction axis (one launch per shard, no concatenated copy); the
        key is the concatenation's shape."""
        mat = as_int32(mat, self.p, self.device)
        if isinstance(blocks, tuple):
            blocks = tuple(self._prep(b) for b in blocks)
            lead = tuple(blocks[0].shape[:-2]) + (
                sum(b.shape[-2] for b in blocks),)
        else:
            blocks = self._prep(blocks)
            lead = tuple(blocks.shape[:-1])
        s = (blocks[0] if isinstance(blocks, tuple) else blocks).shape[-1]
        mm = self.backend.matmul
        key = self._tagged(("matmul", tuple(mat.shape), lead,
                            self.stream_pad(s)[0]), tag)
        return self._launch(
            "matmul", lambda a, x, out=None: mm(a, x, self.p, out=out),
            (mat, blocks), lead[:-1] + (mat.shape[-2], s), key, tag)

    def circulant_encode(self, data, c, *, tag: Optional[str] = None,
                         ) -> PlanResult:
        """The paper's eq. (2) encode; the coefficient tuple is part of the
        plan key."""
        c = tuple(int(x) for x in c)
        enc = self.backend.circulant_encode
        data = self._prep(data)
        key = self._tagged(("circ", data.shape[0], c,
                            self.stream_pad(data.shape[-1])[0]), tag)
        return self._launch(
            "circulant_encode", lambda d, out=None: enc(d, c, self.p, out=out),
            (data,), tuple(data.shape), key, tag)

    def regenerate(self, rmat, r_prev, next_data) -> PlanResult:
        """The fused (2, k+1) repair-matrix application: one matmul launch
        per shard over the row sources (r_prev, next_data), one plan per
        (k, bucket)."""
        rmat = as_int32(rmat, self.p, self.device)
        r_prev, next_data = self._prep(r_prev), self._prep(next_data)
        s = r_prev.shape[-1]
        key = ("regen", next_data.shape[0], self.stream_pad(s)[0])
        return self._launch("regenerate", self._regen_fn(),
                            (rmat, r_prev, next_data), (rmat.shape[0], s),
                            key)

    def regenerate_batch(self, rmat, r_prevs, next_data) -> PlanResult:
        """Batched fused regeneration — one matmul launch per shard for
        all F failed nodes.  Both variable axes are bucketed in the plan
        key (stream on the symbol ladder, F on the batch ladder);
        ``host()`` returns the exact (F, 2, S) stack."""
        rmat = as_int32(rmat, self.p, self.device)
        r_prevs, next_data = self._prep(r_prevs), self._prep(next_data)
        s = r_prevs.shape[-1]
        f, k = next_data.shape[0], next_data.shape[1]
        key = ("regen_batch", self.batch_bucket(f), k, self.stream_pad(s)[0])
        return self._launch("regenerate_batch", self._regen_fn(),
                            (rmat, r_prevs, next_data),
                            (f, rmat.shape[0], s), key, batch=f)

    def matmul_batch(self, mats, blocks, *,
                     tag: Optional[str] = None) -> PlanResult:
        """Per-element batched (q, d) @ (d, S) mod p — the coalesced
        regeneration for families without a node-invariant repair matrix
        (product-matrix MSR): one launch per shard with one matrix per
        element.

        mats: (F, q, d); blocks: (F, d, S).  Both the batch and the stream
        axis are bucketed in the plan key; ``host()`` returns the exact
        (F, q, S) stack."""
        ms, bs = np.shape(mats), np.shape(blocks)
        if len(ms) != 3 or len(bs) != 3 or ms[0] != bs[0] or ms[2] != bs[1]:
            raise ValueError(f"matmul_batch needs (F, q, d) mats and "
                             f"(F, d, S) blocks, got {tuple(ms)} / "
                             f"{tuple(bs)}")
        mats = as_int32(mats, self.p, self.device)
        f, s = bs[0], bs[-1]
        mm = self.backend.matmul
        key = self._tagged(("matmul_batch", tuple(mats.shape[1:]),
                            self.batch_bucket(f), self.stream_pad(s)[0]), tag)
        return self._launch(
            "matmul_batch", lambda a, x, out=None: mm(a, x, self.p, out=out),
            (mats, self._prep(blocks)), (f, ms[1], s), key, tag, batch=f)

    def _regen_fn(self):
        return make_regen_fn(self.backend.matmul, self.p)


def _donation(donate: Optional[bool], device: torch.device) -> bool:
    """``donate`` as the reference normalizes it: None is on for a
    device backend and off on the CPU."""
    return device.type != "cpu" if donate is None else bool(donate)


def _normalize_mesh(mesh, device):
    """The reference's normalization: ``mesh`` coerced to a StreamMesh
    (or None), ``device`` following the mesh (its first device; another
    raises), then a 1-shard mesh dropped — so ``mesh=1`` gives the plain
    unsharded planner."""
    mesh = as_stream_mesh(mesh)
    device = mesh_device(mesh, device)
    if mesh is not None and mesh.is_trivial:
        mesh = None
    return mesh, device


# --------------------------------------------------------------- registry
def get_planner(backend, p: int, *, bucket_min: int = BUCKET_MIN,
                bucket_ratio: float = BUCKET_RATIO,
                donate: Optional[bool] = None, mesh=None,
                device=None) -> PlanCache:
    """The shared PlanCache for (backend, p, ladder, donation, mesh,
    device): every code and engine on the same backend, mesh and device
    shares one plan cache.  A 1-shard mesh is no mesh, so ``mesh=1``
    returns the unsharded planner.  ``donate`` is recorded only (see
    :class:`PlanCache`)."""
    mesh, device = _normalize_mesh(mesh, device)
    dev = resolve_device(device)
    donate = False if mesh is not None else _donation(donate, dev)
    key = (getattr(backend, "name", id(backend)), int(p), int(bucket_min),
           float(bucket_ratio), donate,
           None if mesh is None else mesh.key(), str(canonical_device(dev)))
    with _LOCK:
        pc = _REGISTRY.get(key)
        if pc is None:
            pc = PlanCache(backend, p, bucket_min=bucket_min,
                           bucket_ratio=bucket_ratio, donate=donate,
                           mesh=mesh, device=dev)
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
