"""Sampling hooks for the dry run alone (``repro_torch.launch.dryrun``).

A dry run counts a step's operations on a mesh of ``meta`` positions,
where every batch shard runs the same ops on equal shapes and every
timestep of a recurrence the same ops on the same shapes.  Within
:func:`sample`, the port's loops over batch groups
(``parallel.MeshRun.each``) and over an sLSTM's timesteps (:func:`steps`,
:func:`stack`) run their body for the first few iterations only, and the
others get stand-ins: new empty tensors of the shapes a run iteration
gave, which require no gradient.  The code around the loops still runs in full, so
each count of such a run is affine in the number of live iterations and
runs at two numbers give the count of the whole loop.  Outside
:func:`sample` (every real step) the hooks do nothing; inside it they
refuse tensors that hold values.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import _disable_current_modes

# (live batch groups, live timesteps) while a dry run samples
_LIVE: tuple[Optional[int], Optional[int]] = (None, None)


@contextlib.contextmanager
def sample(groups: Optional[int] = None, steps: Optional[int] = None):
    """Run ``groups`` batch groups and ``steps`` timesteps of each
    recurrence in the block (None: all)."""
    global _LIVE
    prev, _LIVE = _LIVE, (groups, steps)
    try:
        yield
    finally:
        _LIVE = prev


def live_groups(n: int) -> int:
    """How many of ``n`` batch groups to run."""
    return n if _LIVE[0] is None else min(n, _LIVE[0])


def steps(s: int, like: torch.Tensor) -> range:
    """The timesteps of an ``s``-step recurrence over ``like``'s rows to
    run: all of them, or the first few while sampling."""
    if _LIVE[1] is None or _LIVE[1] >= s:
        return range(s)
    _need_meta(like)
    return range(_LIVE[1])


def stack(hs: list, s: int, dim: int) -> torch.Tensor:
    """``torch.stack(hs, dim)`` of an ``s``-step recurrence's per-step
    outputs.  While sampling, ``hs`` holds the live steps only: their
    stack is joined along ``dim`` to a stand-in for the rest outside the
    count (with the dispatch modes off), so the counted ops are those of
    the live steps (the join's backward only slices, a view) and the
    result has the full shape with the live steps' gradient path."""
    out = torch.stack(hs, dim)
    if len(hs) == s:
        return out
    shape = list(out.shape)
    shape[dim] = s - len(hs)
    with _disable_current_modes():
        pad = torch.empty(shape, dtype=out.dtype, device=out.device)
        return torch.cat([out, pad], dim)


def stand_in(x, where: dict):
    """``x`` (an iteration's result) with each tensor replaced by a new
    empty one of its shape and dtype and each dict key in ``where`` (a
    position of group 0) renamed to its value."""
    if isinstance(x, torch.Tensor):
        _need_meta(x)
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if isinstance(x, dict):
        return {where.get(k, k): stand_in(v, where) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(stand_in(v, where) for v in x)
    return x


def _need_meta(x: torch.Tensor) -> None:
    if not x.is_meta:
        raise ValueError("only meta tensors may be sampled (a stand-in "
                         "holds no values)")


__all__ = ["sample", "live_groups", "steps", "stack", "stand_in"]
