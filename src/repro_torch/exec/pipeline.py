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
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Any, Callable, Iterable, Optional, Sequence

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
        clock's stages."""
        with self._stage_lock:
            self._stage = dict.fromkeys(staging.PIPELINE_STAGES, 0.0)
            self._stage_base = staging.stage_times()

    def _timed(self, stage: str, fn: Callable, *args):
        """``fn(*args)`` timed as stage ``stage`` on the process clock
        and in this pipeline's sum ``t_<stage>``."""
        with staging.staged(stage) as span:
            out = fn(*args)
        with self._stage_lock:
            self._stage["t_" + stage] += span.seconds
        return out

    def stage_stats(self) -> dict:
        """Cumulative wall seconds per stage since the last
        :meth:`reset_stage_stats`; every key of
        `repro_torch.exec.staging.STAGE_NAMES`, 0.0 where nothing ran.

        This pipeline's own stages, timed around its callbacks:

        * ``t_stage_read``: the read callbacks (pool-thread time at depth
          >= 2, where it overlaps the rest);
        * ``t_read_wait``: the calling thread blocked on a read's result
          (at depth 1 the read itself, which runs inline);
        * ``t_dispatch`` / ``t_consume``: the compute / consume
          callbacks, on the calling thread;
        * ``t_barrier``: each ``map``'s closing barrier, the calling
          thread waiting for the installs its consumes submitted.

        Deltas of the process-wide stage clock, wherever they ran:
        ``t_pack`` (flatten / pack257 staging writes), ``t_h2d``
        (host operands staged onto the device), the store's ``t_chunk``
        (a put's payload into int32 blocks), ``t_commit`` (a put's
        commit), ``t_crc`` (share CRCs at put and of verified helper
        reads; summed thread-seconds), ``t_install`` (a put window's
        per-share work, its CRC and block assembly; summed
        thread-seconds), the repair scheduler's
        ``t_select`` (queue walk and newcomer provisioning) and
        ``t_gather`` (the repair's helper gather, summed thread-seconds),
        and the read front end's ``t_fe_fetch`` (a pump's share fetches
        and CRC checks), ``t_fe_decode`` (its cross-key decode map),
        ``t_tick_pump`` and ``t_tick_drain`` (a ``tick``'s pump and its
        repair drain), each on the calling thread.

        On a put, ``t_chunk + t_read_wait + t_dispatch + t_consume +
        t_barrier + t_commit`` accounts for the calling thread's time;
        on a drain tick, ``t_select + t_read_wait + t_dispatch +
        t_consume + t_barrier``.
        """
        g = staging.stage_times()
        with self._stage_lock:
            out = dict(self._stage)
            base = self._stage_base
        for key in staging.CLOCK_STAGES:
            out[key] = g.get(key[2:], 0.0) - base.get(key[2:], 0.0)
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

    def fan_out(self, n: int, task: Callable[[int], Any], *,
                helpers: int = 0,
                around: Optional[Callable[[], Any]] = None) -> list:
        """``[task(i) for i in range(n)]``, run by the calling thread and
        up to ``helpers`` pool threads that pull indices from one shared
        cursor (``helpers=0`` is the serial loop).

        The calling thread always takes part, so the call completes even
        if no pool thread ever starts: it cannot deadlock at any pool
        size, from a pool thread too (a read prefetched while another
        fans out).  A pool thread that starts once the cursor has run
        out returns at once; nothing waits for it.  Once a task raises,
        no further index is handed out, and when the tasks running have
        ended the error of the lowest failing index is raised: the one a
        serial loop raises, since every lower index was handed out
        earlier and has ended.

        ``around``, when given, is a context-manager factory that each
        thread taking part enters once, before its first task, and
        leaves after its last: per-thread set-up such as a stage tally,
        paid once a thread rather than once a task.  The call returns
        only after every thread has left it.
        """
        results: list = [None] * n
        errors: dict = {}
        cond = threading.Condition()
        cursor, running = [0], [0]

        def run_tasks() -> None:
            while True:
                with cond:
                    if cursor[0] >= n or errors:
                        return
                    i = cursor[0]
                    cursor[0] += 1
                try:
                    results[i] = task(i)
                except BaseException as e:   # raised by the caller
                    with cond:
                        errors[i] = e

        def participate() -> None:
            with cond:
                if cursor[0] >= n or errors:
                    return
                running[0] += 1
            try:
                if around is None:
                    run_tasks()
                else:
                    with around():
                        run_tasks()
            except BaseException as e:      # around itself: after any task
                with cond:
                    errors.setdefault(n, e)
            finally:
                with cond:
                    running[0] -= 1
                    cond.notify_all()

        for _ in range(max(0, min(int(helpers), n - 1))):
            self._pool().submit(participate)
        participate()
        with cond:
            cond.wait_for(lambda: running[0] == 0)
        if errors:
            raise errors[min(errors)]
        return results

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
                return self._timed("stage_read", read, it)

        # depth 1 is the true serial baseline: no prefetch, reads run
        # inline — stage overlap exists only at depth >= 2
        ahead = self.depth if self.depth > 1 else 0
        read_futs: dict[int, Future] = {}
        if read is not None:
            for j in range(min(ahead, len(items))):
                read_futs[j] = self._pool().submit(timed_read, items[j])

        pending: deque = deque()
        try:
            for i, item in enumerate(items):
                if read is not None:
                    if i in read_futs:
                        data = self._timed("read_wait",
                                           read_futs.pop(i).result)
                    else:
                        data = self._timed("read_wait", timed_read,
                                           items[i])
                    nxt = i + ahead
                    if ahead and nxt < len(items):
                        read_futs[nxt] = self._pool().submit(
                            timed_read, items[nxt])
                    out = self._timed("dispatch", compute, item, data)
                else:
                    out = self._timed("dispatch", compute, item)
                pending.append((item, out))
                while len(pending) >= self.depth:
                    self._timed("consume", consume, *pending.popleft())
            while pending:
                self._timed("consume", consume, *pending.popleft())
        finally:
            # error path: drop the prefetches, and wait for those already
            # running, so that no read outlives the call
            wait([f for f in read_futs.values() if not f.cancel()])
        self._timed("barrier", self.barrier)


__all__ = ["Pipeline", "DEFAULT_DEPTH"]
