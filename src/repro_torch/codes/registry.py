"""Code-family registry (the port of ``repro.codes.registry``, DESIGN.md
§15.1): family name -> constructor.

``make_code`` turns a serializable
:class:`~repro_torch.codes.base.CodeClass` back into a live
:class:`~repro_torch.codes.base.ErasureCode` on a chosen backend and
device — the store does this lazily per object, the conversion
path for its target class, and tests for the whole (n, k, d) grid.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.circulant import CodeSpec

from .base import CodeClass, ErasureCode

FAMILY_DOUBLE_CIRCULANT = "double-circulant"
FAMILY_PRODUCT_MATRIX = "product-matrix"

_FAMILIES: dict[str, Callable[..., ErasureCode]] = {}


def register_family(name: str):
    """Class decorator: register an ErasureCode subclass under ``name``
    (re-registration replaces — the test-override seam)."""
    def deco(cls):
        _FAMILIES[name] = cls
        cls.family = name
        return cls
    return deco


def families() -> list[str]:
    """Registered family names, sorted."""
    _load_builtins()
    return sorted(_FAMILIES)


def make_code(code_class: CodeClass, *, backend: Optional[str] = None,
              mesh=None, device=None, **kwargs) -> ErasureCode:
    """Build the live code for a descriptor on ``device`` (None is the
    card).  Raises ``KeyError`` with the known families listed when the
    family is unregistered."""
    _load_builtins()
    try:
        factory = _FAMILIES[code_class.family]
    except KeyError:
        raise KeyError(f"unknown code family {code_class.family!r}; "
                       f"registered: {sorted(_FAMILIES)}") from None
    return factory(code_class, backend=backend, mesh=mesh, device=device,
                   **kwargs)


def default_code_class(spec: CodeSpec) -> CodeClass:
    """The double-circulant class of a legacy CodeSpec — what every
    object stored before per-object classes implicitly used."""
    return CodeClass(family=FAMILY_DOUBLE_CIRCULANT, n=spec.n, k=spec.k,
                     d=spec.k + 1, p=spec.p)


def _load_builtins() -> None:
    """Import the built-in families exactly once (they self-register);
    deferred so ``base``/``registry`` stay import-cycle-free."""
    from . import double_circulant, product_matrix  # noqa: F401


__all__ = ["FAMILY_DOUBLE_CIRCULANT", "FAMILY_PRODUCT_MATRIX",
           "register_family", "families", "make_code", "default_code_class"]
