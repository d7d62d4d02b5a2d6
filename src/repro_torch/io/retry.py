"""Bounded-retry policy with exponential backoff and deterministic
jitter (the port of ``repro.io.retry``, DESIGN.md §12.3).

Every share read/write the durability layer performs is wrapped in a
:class:`RetryPolicy` call: transient failures (``OSError`` and friends
— the class a flaky disk, NFS hiccup or injected fault raises) are
retried up to ``max_attempts`` times under a per-op wall-clock budget
``op_timeout_s``; persistent failures surface as ONE typed
:class:`GiveUpError` carrying the op name, attempt count and the last
underlying exception as ``__cause__`` — callers never see a raw
``OSError`` escape a retried path without the policy having given up
on it first.

Jitter is *deterministic*: the delay for attempt ``a`` of op ``o`` is
``base * multiplier**a`` scaled by a factor in ``[1-jitter, 1+jitter]``
derived from ``crc32(f"{o}|{a}")`` — two runs with the same fault seed
take identical backoff paths, which is what makes the drill harness's
retry-amplification numbers reproducible.

:class:`RetryStats` is the shared accounting object: ops, attempts,
retries, give-ups, and the headline ``amplification`` ratio
(attempts / ops) `BENCH_drills.json` reports per injected fault rate.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Callable, Optional

# Error classes a retry may heal: I/O-flavoured and timing-flavoured.
# Everything else (ValueError from a corrupt decode, KeyError, ...) is a
# logic error and propagates on the first attempt.
TRANSIENT_ERRORS: tuple[type, ...] = (OSError, TimeoutError)


class GiveUpError(RuntimeError):
    """A retried op exhausted its attempt/time budget (typed give-up).

    ``__cause__`` is the last underlying exception; ``op``/``attempts``/
    ``elapsed_s`` say what was tried and for how long.  Deliberately NOT
    an ``OSError`` subclass, so an outer retry layer never re-retries a
    give-up.
    """

    def __init__(self, op: str, attempts: int, elapsed_s: float,
                 last: BaseException):
        super().__init__(f"gave up on {op!r} after {attempts} attempt(s) "
                         f"in {elapsed_s:.3f}s: {last!r}")
        self.op = op
        self.attempts = attempts
        self.elapsed_s = elapsed_s


class RetryStats:
    """Thread-safe retry accounting shared across a component's ops."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ops = 0          # logical operations (calls to RetryPolicy.call)
        self.attempts = 0     # total attempts including retries
        self.retries = 0      # attempts beyond each op's first
        self.giveups = 0

    def record(self, attempts: int, gave_up: bool) -> None:
        with self._lock:
            self.ops += 1
            self.attempts += attempts
            self.retries += attempts - 1
            self.giveups += int(gave_up)

    @property
    def amplification(self) -> float:
        """attempts / ops — 1.0 means no retry ever fired."""
        return self.attempts / self.ops if self.ops else 1.0

    def summary(self) -> dict:
        return {"ops": self.ops, "attempts": self.attempts,
                "retries": self.retries, "giveups": self.giveups,
                "amplification": round(self.amplification, 4)}


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries + exponential backoff + deterministic jitter.

    Parameters
    ----------
    max_attempts : int
        Total tries per op (1 = no retry).
    base_delay_s, multiplier, max_delay_s : float
        Backoff curve: attempt ``a`` waits
        ``min(base * multiplier**a, max_delay)`` (jittered) before
        retrying.
    jitter : float
        Fractional jitter width; the deterministic factor lands in
        ``[1-jitter, 1+jitter]``.
    op_timeout_s : float
        Wall-clock budget per op ACROSS attempts: when elapsed time plus
        the next backoff would exceed it, the policy gives up early.
    retryable : tuple of exception types
        What counts as transient (default :data:`TRANSIENT_ERRORS`).
    sleep, clock : callables
        Injectable for tests and drills (``sleep=lambda s: None`` makes
        backoff schedules free to simulate).
    """

    max_attempts: int = 4
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    jitter: float = 0.5
    op_timeout_s: float = 30.0
    retryable: tuple = TRANSIENT_ERRORS
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        if self.op_timeout_s <= 0:
            raise ValueError("op_timeout_s must be positive")

    def delay_s(self, op: str, attempt: int) -> float:
        """The (deterministic) backoff before retry number ``attempt``."""
        d = min(self.base_delay_s * self.multiplier ** attempt,
                self.max_delay_s)
        h = zlib.crc32(f"{op}|{attempt}".encode()) / 0xFFFFFFFF
        return d * (1.0 - self.jitter + 2.0 * self.jitter * h)

    def call(self, fn: Callable[[], object], *, op: str = "io",
             stats: Optional[RetryStats] = None,
             budget_s: Optional[float] = None):
        """Run ``fn()`` under the policy; returns its value or raises
        :class:`GiveUpError` once the attempt/time budget is spent.

        ``budget_s`` caps the wall-clock budget below ``op_timeout_s``
        for this one call — deadline propagation (DESIGN.md §13.1): a
        serving request's remaining deadline bounds how long any of its
        share fetches may keep retrying.  The first attempt always
        runs, even on an exhausted budget, so a zero budget degrades to
        try-once rather than fail-without-trying."""
        limit = self.op_timeout_s if budget_s is None \
            else min(self.op_timeout_s, max(0.0, budget_s))
        t0 = self.clock()
        last: Optional[BaseException] = None
        attempts = 0
        while True:
            attempts += 1
            try:
                out = fn()
            except self.retryable as e:
                last = e
            else:
                if stats is not None:
                    stats.record(attempts, gave_up=False)
                return out
            elapsed = self.clock() - t0
            if attempts >= self.max_attempts or elapsed >= limit:
                break
            d = self.delay_s(op, attempts - 1)
            if elapsed + d > limit:
                break
            self.sleep(d)
        if stats is not None:
            stats.record(attempts, gave_up=True)
        raise GiveUpError(op, attempts, self.clock() - t0, last) from last


def fast_retry(**overrides) -> RetryPolicy:
    """A RetryPolicy whose backoff sleeps are no-ops — drills and tests
    exercise the full retry/give-up logic without wall-clock cost."""
    kw = dict(max_attempts=4, base_delay_s=0.001, sleep=lambda _s: None)
    kw.update(overrides)
    return RetryPolicy(**kw)


__all__ = ["RetryPolicy", "RetryStats", "GiveUpError", "TRANSIENT_ERRORS",
           "fast_retry"]
