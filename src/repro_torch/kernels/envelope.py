"""The lazy mod-folding exactness envelope — single source of truth for
every chunk/fold bound in the port's GF compute layer (the PyTorch twin
of ``repro.kernels.envelope``, same constants).

Two accumulation regimes:

* integer lanes: every term is <= (p-1)^2; a partial sum of
  ``int32_lazy_terms(p)`` terms stays inside int32 even when it lands on a
  post-fold residual (< p), so one `% p` per chunk suffices.  Both Hopper
  kernels (``csrc/*.cu``) and both plain versions (``ref.py``) fold on
  this schedule.
* fp32 chunk sums: a dot of ``f32_exact_terms(p)`` terms is exact in fp32
  (< 2^24).  Cast to int32, ``LAZY_F32_CHUNKS`` such partials accumulate
  before a fold — the post-fold residual (< p <= 2^24) costs one chunk of
  headroom, so (LAZY + 1) * (2^24 - 1) <= 2^31 - 1  =>  LAZY = 127.  The
  port has no fp32 schedule yet; the constant is kept so the two
  packages state one envelope.

Both term helpers return 0 when a SINGLE product already exceeds the
range; callers must reject (``require_int32_envelope``).
"""
from __future__ import annotations

LAZY_F32_CHUNKS = (2**31 - 1) // (2**24 - 1) - 1      # = 127

# largest p whose single product (p-1)^2 fits int32: int32 lanes are the
# widest exact path this layer has, so this bounds the whole compute layer
INT32_MAX_P = 46341


def int32_lazy_terms(p: int) -> int:
    """Max un-folded terms per int32 chunk: residual (< p) + chunk * (p-1)^2
    must stay <= 2^31 - 1.  32767 terms for p = 257; 0 when even one
    product overflows int32 (p > 46341)."""
    return (2**31 - 1 - (p - 1)) // max((p - 1) ** 2, 1)


def require_int32_envelope(p: int) -> None:
    if int32_lazy_terms(p) < 1:
        raise ValueError(f"(p-1)^2 > 2^31-1: int32 lanes cannot be exact for "
                         f"p={p} (largest supported p is {INT32_MAX_P})")


def f32_exact_terms(p: int) -> int:
    """Max contraction terms exact in a single fp32 accumulation:
    terms * (p-1)^2 <= 2^24 - 1.  255 for p = 257; 0 when even one
    product is inexact (p > 4097)."""
    return (2**24 - 1) // max((p - 1) ** 2, 1)


__all__ = ["LAZY_F32_CHUNKS", "INT32_MAX_P", "int32_lazy_terms",
           "f32_exact_terms", "require_int32_envelope"]
