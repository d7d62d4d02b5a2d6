"""Overlapped read → compute → consume pipeline (the port of
``repro.exec.pipeline``).

One stage engine for every hot path of the object store (put windows,
degraded-read decode groups, coalesced repair windows):

    read (thread pool)  →  compute (asynchronous launch)  →  consume

The engine is *depth-bounded*: compute for item t+1..t+depth-1 is
launched before item t's result is consumed, so at most ``depth``
device results are in flight (depth 2 = double buffering; depth 1 =
serial, the no-overlap baseline).  Reads prefetch ``depth`` items ahead
through the pool, and consume callbacks may :meth:`Pipeline.submit`
host writes onto the same pool — joined, with errors surfaced, at
:meth:`barrier`/exit.

CUDA launches are asynchronous, so ``compute`` returning a
:class:`~repro_torch.exec.plan.PlanResult` costs only the launch; the
blocking copy back happens inside ``consume`` (``.host()``), which waits
for that item's own kernel — by which point the NEXT item's kernel is
already queued on the card while the pool moves bytes.

Two lifecycles:

* context-managed: ``with Pipeline(...) as p:`` — exit joins every
  submitted future and surfaces the first error;
* persistent (the object store keeps one pipeline for its lifetime):
  each :meth:`map`/:meth:`stream_tiles` call barriers its own work, the
  pool thread(s) are reused across calls, :meth:`close` shuts down.
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from time import perf_counter
from typing import Callable, Iterable, Optional, Sequence

from . import staging

DEFAULT_DEPTH = 2


class Pipeline:
    """Depth-bounded read → compute → consume engine with a shared
    host-I/O pool.

    Parameters
    ----------
    io_workers : int
        Pool threads for reads and submitted writes.
    depth : int
        Max device results in flight (1 = serial; 2 = double-buffered).

    Notes
    -----
    A pipeline instance is not re-entrant: one ``map``/``stream_tiles``
    runs at a time (the store and checkpointer each own theirs).
    """

    def __init__(self, *, io_workers: int = 4, depth: int = DEFAULT_DEPTH):
        self.io_workers = max(1, int(io_workers))
        self.depth = max(1, int(depth))
        self._ex: Optional[ThreadPoolExecutor] = None
        self._futs: list[Future] = []
        self._stage_lock = threading.Lock()
        self._stage: dict = {}
        self.reset_stage_stats()

    # ------------------------------------------------------ stage accounting
    def reset_stage_stats(self) -> None:
        """Zero this pipeline's stage timers and rebase the process-wide
        pack/pad clocks."""
        with self._stage_lock:
            self._stage = {"t_stage_read": 0.0, "t_dispatch": 0.0,
                           "t_consume": 0.0}
            self._stage_base = staging.stage_times()

    def _acct(self, name: str, dt: float) -> None:
        with self._stage_lock:
            self._stage[name] += dt

    def stage_stats(self) -> dict:
        """Cumulative wall seconds per pipeline stage since the last
        :meth:`reset_stage_stats`.

        ``t_stage_read`` / ``t_dispatch`` / ``t_consume`` are timed
        around this pipeline's read/compute/consume callbacks (read time
        is pool-thread time, so at depth >= 2 it largely overlaps the
        other two).  ``t_pack`` (flatten / pack257 staging writes) and
        ``t_pad`` (bucket padding; always 0 here, where the kernels mask
        the ragged edge instead) are deltas of the process-wide stage
        clock in `repro_torch.exec.staging` — the staging work those
        callbacks triggered, wherever it ran.
        """
        g = staging.stage_times()
        with self._stage_lock:
            out = dict(self._stage)
            base = self._stage_base
        out["t_pack"] = g.get("pack", 0.0) - base.get("pack", 0.0)
        out["t_pad"] = g.get("pad", 0.0) - base.get("pad", 0.0)
        return out

    # ------------------------------------------------------------ lifecycle
    def _pool(self) -> ThreadPoolExecutor:
        if self._ex is None:
            self._ex = ThreadPoolExecutor(max_workers=self.io_workers)
        return self._ex

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:                      # don't mask the in-flight exception,
            self.close(wait=True, surface=False)   # but never leak threads
        return None

    def close(self, *, wait: bool = True, surface: bool = True) -> None:
        """Join tracked futures (surfacing the first error) and shut the
        pool down; the pipeline may be reused afterwards (a fresh pool
        is created lazily)."""
        try:
            if surface:
                self.barrier()
        finally:
            if self._ex is not None:
                self._ex.shutdown(wait=wait)
                self._ex = None
                self._futs = []

    # ----------------------------------------------------------- host pool
    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        """Schedule a host I/O task (file write, share placement, read)
        on the pool; tracked until the next :meth:`barrier`."""
        fut = self._pool().submit(fn, *args, **kwargs)
        self._futs.append(fut)
        return fut

    def barrier(self) -> None:
        """Wait for every tracked future; re-raise the first failure."""
        futs, self._futs = self._futs, []
        for f in futs:
            f.result()

    # -------------------------------------------------------------- stages
    def stream_tiles(self, s_total: int, tile: int,
                     compute: Callable, consume: Callable) -> None:
        """Depth-bounded tile loop over one stream axis (the engine the
        checkpointer's save/restore/scrub share).

        ``compute(sl)`` dispatches stream slice ``sl`` to the device and
        returns without blocking; ``consume(sl, result)`` lands the
        result host-side.  With depth d, tile t is consumed only after
        tiles t+1..t+d-1 have been dispatched.
        """
        tile = max(1, int(tile))
        self.map([slice(s0, min(s0 + tile, s_total))
                  for s0 in range(0, s_total, tile)], compute, consume)

    def map(self, items: Iterable, compute: Callable, consume: Callable, *,
            read: Optional[Callable] = None) -> None:
        """Run ``items`` through read → compute → consume, depth-bounded.

        Parameters
        ----------
        items : iterable
            Work descriptors, processed (and consumed) in order.
        compute : callable
            ``compute(item)`` — or ``compute(item, read_result)`` when
            ``read`` is given.  Should launch asynchronously (a
            PlanResult); its return value is handed to consume.
        consume : callable
            ``consume(item, compute_result)`` — the blocking stage; may
            :meth:`submit` further host writes.
        read : callable, optional
            ``read(item)`` runs on the pool, prefetched ``depth`` items
            ahead of compute.
        """
        items = list(items)
        if not items:
            return

        timed_read = None
        if read is not None:
            def timed_read(it):
                t0 = perf_counter()
                data = read(it)
                self._acct("t_stage_read", perf_counter() - t0)
                return data

        # depth 1 is the true serial baseline: no prefetch, reads run
        # inline — stage overlap exists only at depth >= 2
        ahead = self.depth if self.depth > 1 else 0
        read_futs: dict[int, Future] = {}
        if read is not None:
            for j in range(min(ahead, len(items))):
                read_futs[j] = self._pool().submit(timed_read, items[j])

        def _consume(it0, out0):
            t0 = perf_counter()
            consume(it0, out0)
            self._acct("t_consume", perf_counter() - t0)

        pending: deque = deque()
        try:
            for i, item in enumerate(items):
                if read is not None:
                    if i in read_futs:
                        data = read_futs.pop(i).result()
                    else:
                        data = timed_read(items[i])
                    nxt = i + ahead
                    if ahead and nxt < len(items):
                        read_futs[nxt] = self._pool().submit(
                            timed_read, items[nxt])
                    t0 = perf_counter()
                    out = compute(item, data)
                else:
                    t0 = perf_counter()
                    out = compute(item)
                self._acct("t_dispatch", perf_counter() - t0)
                pending.append((item, out))
                while len(pending) >= self.depth:
                    it0, out0 = pending.popleft()
                    _consume(it0, out0)
            while pending:
                it0, out0 = pending.popleft()
                _consume(it0, out0)
        finally:
            for f in read_futs.values():     # error path: drain prefetches
                f.cancel()
        self.barrier()


__all__ = ["Pipeline", "DEFAULT_DEPTH"]
