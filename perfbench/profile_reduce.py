"""Reduce a ``torch.profiler`` trace of a run's window to what the
per-layer metrics read: device time by operation name, the device's busy
time (the union of its kernel, copy and set intervals), and the idle
gaps between them attributed to what the host was doing then.

The host's activity is the benchmark's own spans (``span``): named
``torch.profiler.record_function`` ranges around its calls into each
layer, which land in the trace on the host clock that the device's
events are aligned to.  The window itself is the span ``window``.
"""
from __future__ import annotations

import contextlib

PREFIX = "perfbench."
WINDOW = PREFIX + "window"


def span(name: str, on: bool):
    """A named host span in the trace when ``on``, else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(PREFIX + name)


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals, in their unit."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float,
         ) -> list[tuple[float, float]]:
    """The parts of [lo, hi] no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def label(t: float, spans: list[tuple[float, float, str]]) -> str:
    """The innermost host span covering time ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "outside any span"


def reduce_events(device: list[tuple[float, float, str]],
                  host: list[tuple[float, float, str]]) -> dict:
    """The window's device summary from device events and host spans,
    each (start_us, end_us, name); the host spans include ``WINDOW``."""
    win = [(a, b) for a, b, n in host if n == WINDOW]
    if not win:
        raise ValueError("no window span in the trace")
    lo, hi = win[0]
    clipped = [(max(a, lo), min(b, hi), n) for a, b, n in device
               if b > lo and a < hi]
    by_name: dict[str, float] = {}
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    busy = [(a, b) for a, b, _n in clipped]
    inner = [(a, b, n[len(PREFIX):]) for a, b, n in host if n != WINDOW]
    idle: dict[str, float] = {}
    for a, b in gaps(busy, lo, hi):
        what = label((a + b) / 2, inner)
        idle[what] = idle.get(what, 0.0) + (b - a) / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": union_s(busy) / 1e6,
            "by_name": by_name, "idle_by_host": idle}


def reduce(prof) -> dict:
    """:func:`reduce_events` of a finished ``torch.profiler.profile``."""
    import torch
    on_card = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end, e.name)
        if e.name.startswith(PREFIX):
            # a span's mirror on the device timeline is no device work
            if e.device_type != on_card:
                host.append(rng)
        elif e.device_type == on_card:
            device.append(rng)
    return reduce_events(device, host)


def top(d: dict, n: int = 10) -> list[list]:
    """The ``n`` largest entries of a name -> seconds map, as pairs."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def seconds_where(by_name: dict, word: str) -> float:
    """Device seconds of the operations whose name contains ``word``."""
    return sum(v for k, v in by_name.items() if word in k)


__all__ = ["span", "union_s", "gaps", "label", "reduce_events", "reduce",
           "top", "seconds_where", "WINDOW"]
