"""GF(p) backend dispatch: a registry of exact compute implementations
(the port of ``repro.kernels.dispatch``).

Every hot path of the MSR layer reduces to three primitives over GF(p):

    matmul(a, b, p)              (m, k) @ (k, s) mod p, optionally batched;
                                 b may be a tuple of 1-4 row sources
    circulant_encode(data, c, p) the paper's eq. (2), k MACs/symbol
    axpy(y, alpha, x, p)         the regenerate-path scale+accumulate

Each registered backend implements all three with bit-exact integer
semantics on torch tensors:

  * ``torch-int32``  the plain PyTorch versions (``ref.py``): int64
                     elementwise multiply-adds folded on the int32
                     schedule.  Runs on the CPU and the card; the
                     counterpart of the reference's ``jnp-int32``.
  * ``cuda``         the hand-written Hopper kernels (``csrc/*.cu``) for
                     matmul and encode; axpy is plain elementwise torch on
                     the device, as the reference's ``pallas`` backend
                     leaves it to ``gf_axpy_ref``.  On a CPU tensor each
                     kernel wrapper runs its plain version.

Both backends take ``matmul``'s contraction operand as one tensor or as
a tuple of 1-4 row sources (``ref.matmul_sources``), read as if
concatenated along the contraction axis: ``cuda`` hands them to the
kernel where they lie, ``torch-int32`` concatenates them first.  The
fused repair engine uses the tuple form; a custom injected matmul is
never given one.

Selection is automatic from ``(device, p, k)`` via :func:`select`: a CUDA
device gets ``cuda``, the CPU gets ``torch-int32``; the automatic rule
never hands the plain backend to a CUDA device.  Pin with the
``REPRO_TORCH_GF_BACKEND`` environment variable or
:func:`set_default_backend`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from repro_torch.device import resolve_device

from . import ref
from .circulant_encode import circulant_encode as _cuda_circulant
from .envelope import int32_lazy_terms, require_int32_envelope
from .gf_matmul import gf_matmul as _cuda_matmul

ENV_VAR = "REPRO_TORCH_GF_BACKEND"


def fold_count(backend_name: str, p: int, k: int) -> int:
    """Number of ``% p`` folds a k-term contraction costs on a backend.

    Both backends accumulate on integer lanes and fold every
    ``int32_lazy_terms(p)`` terms: ceil(k / 32767) at p = 257."""
    if backend_name not in _REGISTRY:
        raise KeyError(backend_name)
    require_int32_envelope(p)
    return -(-k // int32_lazy_terms(p))


@dataclasses.dataclass(frozen=True)
class GFBackend:
    """One exact implementation of the three GF primitives on tensors."""
    name: str
    matmul: Callable            # (a, b | sources, p, out=None)
                                # -> (m, s) or (F, m, s)
    circulant_encode: Callable  # (data, c: tuple, p, out=None) -> (n, s)
    axpy: Callable              # (y, alpha, x, p) -> int32

    def msr_matmul(self):
        """Adapter for DoubleCirculantMSR(..., matmul=...)."""
        return lambda a, b, p: self.matmul(a, b, p)

    def planner(self, p: int, device=None, *, mesh=None, **plan_kwargs):
        """The shared execution planner for this backend at modulus p on
        ``device``, sharded over ``mesh`` when one is given (lazy import:
        the exec layer sits above kernels)."""
        from repro_torch.exec.plan import get_planner
        return get_planner(self, p, device=device, mesh=mesh, **plan_kwargs)


_REGISTRY: dict[str, GFBackend] = {}
_default_override: Optional[str] = None


def register(backend: GFBackend) -> GFBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get(name: str) -> GFBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown GF backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def get_backend(name: Optional[str] = None, *, p: int = 257,
                k: Optional[int] = None, device=None) -> GFBackend:
    """Resolve a GF backend: by name, or auto-selected for ``device``
    (None is the card)."""
    return get(name) if name else select(p, k, device)


def registered_backends() -> list[str]:
    return sorted(_REGISTRY)


def set_default_backend(name: Optional[str]) -> None:
    """Process-wide override (None restores automatic selection)."""
    global _default_override
    if name is not None:
        get(name)
    _default_override = name


def select(p: int = 257, k: Optional[int] = None, device=None) -> GFBackend:
    """Pick the exact backend for ``device`` (None is the card).

    Priority: ``REPRO_TORCH_GF_BACKEND`` > :func:`set_default_backend` >
    device rule (CUDA -> ``cuda``, CPU -> ``torch-int32``).  Raises for p
    outside every exact envelope (p > 46341), and for a CUDA device on a
    host without CUDA.  Launches nothing.
    """
    del k                       # both backends serve every contraction depth
    env = os.environ.get(ENV_VAR)
    if env:
        if env not in _REGISTRY:
            raise ValueError(
                f"{ENV_VAR}={env!r} is not a registered GF backend; "
                f"valid values: {', '.join(sorted(_REGISTRY))}")
        return get(env)
    if _default_override:
        return get(_default_override)
    require_int32_envelope(p)
    return get("cuda" if resolve_device(device).type == "cuda"
               else "torch-int32")


register(GFBackend(
    name="torch-int32",
    matmul=ref.gf_matmul_ref,
    circulant_encode=ref.circulant_encode_ref,
    axpy=lambda y, alpha, x, p: ref.gf_axpy_ref(y, int(alpha), x, p),
))

register(GFBackend(
    name="cuda",
    matmul=_cuda_matmul,
    circulant_encode=_cuda_circulant,
    axpy=lambda y, alpha, x, p: ref.gf_axpy_ref(y, int(alpha), x, p),
))


__all__ = [
    "GFBackend", "register", "get", "get_backend", "select",
    "registered_backends", "set_default_backend", "int32_lazy_terms",
    "fold_count", "ENV_VAR",
]
