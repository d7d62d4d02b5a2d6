"""Operation statistics of an eager call: the port's counterpart of
``repro.launch.hlo_stats``.

The reference compiles a step and re-derives the roofline inputs from
its optimized HLO, applying each while loop's trip count.  The port has
no HLO: it runs the call eagerly under a ``TorchDispatchMode`` and counts
every ATen operation it dispatches.  A Python loop runs every trip, so
the counts are trip-aware by construction.

  * flops       -- matmul-class ops exactly, by ``torch.utils.flop_counter``'s
                   per-op formulas (2 * numel(result) * K for mm, bmm and
                   the einsums and matmuls that decompose into them);
                   elementwise ops (ATen's ``pointwise`` tag, and a cast
                   that changes dtype) at 1 per result element, reductions
                   at 1 per input element, as the reference counts them
                   (``hlo_stats._instr_flops``).
  * hbm_bytes   -- operand plus result bytes of every op that is not a view
                   or an allocation.  In eager mode every op is a fusion
                   boundary, so this proxy reads higher than XLA's
                   ``bytes accessed``, which counts fused chains once.
  * collectives -- ``sharding.place.traffic`` read over the call: its
                   gathers (blocks and broadcasts read by another mesh
                   position) as ``all-gather`` and its partial sums as
                   ``all-reduce``, each with count and bytes.  The reverse
                   collectives that autograd derives in a backward pass
                   are not in ``place.traffic`` and so not here.

On the ``meta`` device a functional op's result depends only on the
shapes, strides and dtypes of its operands and on its other arguments,
so :func:`analyze` keeps each such op's result layout and counts in a
table and answers a repeat from it (a new empty tensor of that layout)
without running the op's meta function again: a layer stack repeats the
same few hundred ops thousands of times, and the meta functions of
elementwise ops run in Python.  Results on any other device always come
from running the op.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.sharding import place

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_REDUCTIONS = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.prod, _aten.logsumexp, _aten.var, _aten.std, _aten.norm,
    _aten.linalg_vector_norm, _aten.cumsum, _aten.any, _aten.all,
    _aten.argmax, _aten.argmin, _aten.var_mean, _aten._log_softmax,
    _aten._softmax,
}
_CASTS = {_aten._to_copy, _aten.copy_, _aten.copy}
# ops that allocate or relabel memory without touching it
_NO_BYTES = {
    _aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
    _aten.lift_fresh_copy, _aten._unsafe_view,
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(x):
    """A hashable stand-in for one argument: a tensor by its layout, a
    scalar with its type (1, 1.0 and True hash alike)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.is_meta)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    return (type(x), x)


def _flops(func, args, kwargs, out) -> int:
    packet = func.overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    outs = _tensors(out)
    if torch.Tag.pointwise in func.tags:
        return sum(t.numel() for t in outs)
    if packet in _REDUCTIONS:
        return args[0].numel() if isinstance(args[0], torch.Tensor) else 0
    if packet in _CASTS:
        src = _tensors(args)[-1]
        return sum(t.numel() for t in outs if t.dtype != src.dtype)
    return 0


def _bytes(func, args, kwargs, out) -> int:
    if func.overloadpacket in _NO_BYTES or _is_view(func):
        return 0
    return sum(_nbytes(t) for t in _tensors(args) + _tensors(list(
        kwargs.values())) + _tensors(out))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _info(func) -> tuple[bool, bool]:
    """(decomposes, cacheable) of an op: whether it is a composite to
    count by its parts (outside autograd, as under inference mode, one
    reaches the mode whole), and whether it is functional (no aliased or
    written argument or result)."""
    hit = _INFO.get(func)
    if hit is None:
        sch = func._schema
        hit = _INFO[func] = (
            func.overloadpacket not in flop_registry
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"),
            not sch.is_mutable and all(r.alias_info is None
                                       for r in sch.returns))
    return hit


_INFO: dict = {}
# (op, argument layouts) -> (tuple result?, result layouts, flops, bytes),
# kept for ops whose results lie on the meta device
_META_TABLE: dict = {}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        decomposes, cacheable = _info(func)
        if decomposes:
            with self:
                r = func.decompose(*args, **(kwargs or {}))
            if r is not NotImplemented:
                return r
        self.ops += 1
        key = None
        if cacheable:
            key = (func, _key(args), _key(tuple(kwargs.items()))
                   if kwargs else ())
            hit = _META_TABLE.get(key)
            if hit is not None:
                many, layouts, fl, nb = hit
                self.flops += fl
                self.hbm_bytes += nb
                outs = tuple(torch.empty_strided(sh, st, dtype=dt,
                                                 device="meta")
                             for sh, st, dt in layouts)
                return outs if many else outs[0]
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fl = _flops(func, args, kwargs, out)
        nb = _bytes(func, args, kwargs, out)
        self.flops += fl
        self.hbm_bytes += nb
        outs = [out] if isinstance(out, torch.Tensor) else (
            list(out) if isinstance(out, tuple) else [])
        if key is not None and outs and all(
                isinstance(t, torch.Tensor) and t.is_meta for t in outs):
            _META_TABLE[key] = (isinstance(out, tuple), [
                (tuple(t.shape), t.stride(), t.dtype) for t in outs],
                fl, nb)
        return out


def _collectives(gathers: int, gather_bytes: int, reduces: int,
                 reduce_bytes: int) -> dict:
    out = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}
    out["all-gather"] = {"count": gathers, "bytes": gather_bytes}
    out["all-reduce"] = {"count": reduces, "bytes": reduce_bytes}
    out["total_bytes"] = gather_bytes + reduce_bytes
    out["total_count"] = gathers + reduces
    return out


def analyze(fn: Callable, *args: Any) -> dict:
    """``fn(*args)`` run once under the counter: ``{"flops", "hbm_bytes",
    "collectives", "n_ops", "result"}`` -- the reference's keys, the
    number of ATen ops dispatched, and what ``fn`` returned."""
    tr = place.traffic
    t0 = (tr.gathers, tr.gather_bytes, tr.reduces, tr.reduce_bytes)
    mode = _Counter()
    with mode:
        out = fn(*args)
    t1 = (tr.gathers, tr.gather_bytes, tr.reduces, tr.reduce_bytes)
    return {"flops": mode.flops, "hbm_bytes": mode.hbm_bytes,
            "collectives": _collectives(*(b - a for a, b in zip(t0, t1))),
            "n_ops": mode.ops, "result": out}


__all__ = ["analyze", "COLLECTIVES"]
