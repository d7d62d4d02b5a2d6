"""Activation-sharding hint context of the port (``repro.sharding.ctx``).

Parameter placements decide most activation layouts, but some (notably
sequence-parallel attention for head counts that do not divide the model
axis) must be stated explicitly.  Model code calls `constrain(x, kind)`
at the few relevant points (attention's q, scores and output, the
residual stream at each block's entry); outside a `rules(...)` context
(unit tests, unsharded runs) it returns ``x`` itself.  A rule that does
not divide the tensor's dimensions is skipped silently — one policy
serves every arch.

Under the port's single controller an activation is either a
:class:`~repro_torch.sharding.place.Sharded` laid over the mesh (the
residual stream between blocks) or a plain tensor, one position's piece
that the mesh executor (`sharding/parallel.py`) has already laid out.
`constrain` re-lays a ``Sharded`` to the rule's spec and returns a plain
tensor as it is; the executor reads the rules through `spec_for` to pick
sequence-parallel attention.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.sharding.place import Sharded
from repro_torch.sharding.policy import spec_fits

_CTX = contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def rules(mesh, table: dict[str, tuple]):
    tok = _CTX.set((mesh, dict(table)))
    try:
        yield
    finally:
        _CTX.reset(tok)


def spec_for(kind: str, shape: tuple[int, ...]) -> Optional[tuple]:
    """The active rule for ``kind`` if there is one and it fits
    ``shape``; None outside `rules(...)`, for an unknown kind, or when
    the rule does not divide the shape."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, table = ctx
    spec = table.get(kind)
    if spec is None:
        return None
    if len(tuple(spec)) > len(shape) or not spec_fits(spec, tuple(shape),
                                                      mesh):
        return None
    return spec


def constrain(x, kind: str):
    if _CTX.get() is None:
        return x
    spec = spec_for(kind, tuple(x.shape))
    if spec is None or not isinstance(x, Sharded):
        return x
    return x.relayout(spec)


def active() -> bool:
    return _CTX.get() is not None


__all__ = ["rules", "constrain", "spec_for", "active"]
