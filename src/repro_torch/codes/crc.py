"""Put-time CRC32 of one stored share: the integrity ledger's formulas
(DESIGN.md §13.2), one per share layout.

* :func:`share_crc` — the double-circulant ``[node, a, r]`` share: the
  data block as raw uint8 bytes chained with the redundancy block's
  ``pack257`` halves, in the native library ``csrc/share_crc.cpp``;
* :func:`generic_share_crc` — a q-block share of any other family: every
  block's ``pack257`` halves chained.

A family picks its formula in ``ErasureCode.share_crc_blocks``.
"""
from __future__ import annotations

import threading
import zlib
from typing import Any, Sequence

import numpy as np

from repro_torch.core import gf
from repro_torch.kernels import _build


def share_crc(a: np.ndarray, r: np.ndarray) -> int:
    """CRC32 of one node share's LOGICAL payload — the checkpoint
    manifest convention (DESIGN.md §12.2) applied per share: the data
    block as raw uint8 bytes chained with the redundancy block's
    ``pack257`` halves (low bytes, then int64 indexes of 256).  Repairs
    are bit-exact, so a rebuilt share matches its put-time CRC without
    any ledger rewrite.  The same CRC as the reference's for every
    GF(257) share, and for every int32 input (a symbol counts by its low
    byte).

    Hot on every put, helper gather and front-end fetch, so it runs in
    the native library ``csrc/share_crc.cpp``: one pass over the share,
    a carry-less-multiply CRC where the CPU has PCLMULQDQ (a table CRC
    elsewhere), with the interpreter lock released for the whole check of
    a share of 2^15 symbols or more, so the gather's threads at large
    units check their helpers in parallel.  Operands that are not
    C-contiguous int32 are converted first.  A host without a C++
    compiler takes the numpy formula (:func:`_share_crc_numpy`);
    :func:`share_crc_paths` counts the checks by path."""
    global _numpy_checks
    native = _native_crc if _native_crc is not None else _load_native_crc()
    if native is False:
        with _numpy_checks_lock:
            _numpy_checks += 1
        return _share_crc_numpy(a, r)
    crc = native.share_crc(a, r)
    if crc is None:             # an operand is not C-contiguous int32
        crc = native.share_crc(np.ascontiguousarray(a, np.int32),
                               np.ascontiguousarray(r, np.int32))
    return crc


def _share_crc_numpy(a: np.ndarray, r: np.ndarray) -> int:
    """:func:`share_crc` by numpy and zlib: the truncating uint8 cast IS
    ``% 256`` for symbols in [0, 256], and zlib reads the array buffers
    directly."""
    c = zlib.crc32(np.ascontiguousarray(a, np.uint8))
    sym = np.ascontiguousarray(r, np.int32).reshape(-1)
    c = zlib.crc32(sym.astype(np.uint8), c)
    return zlib.crc32(
        np.ascontiguousarray(np.nonzero(sym == 256)[0].astype(np.int64)), c)


# the native library once loaded (False on a host without a C++ compiler),
# and the checks the numpy formula ran
_native_crc: Any = None
_numpy_checks = 0
_numpy_checks_lock = threading.Lock()


def _load_native_crc() -> Any:
    global _native_crc
    mod = _build.load_host("share_crc")
    _native_crc = False if mod is None else mod
    return _native_crc


def share_crc_paths() -> dict[str, int]:
    """Share checks (:func:`share_crc` calls) in this process by the path
    that ran them: ``"clmul"`` (the native carry-less-multiply CRC),
    ``"table"`` (the native table CRC, on a CPU without PCLMULQDQ) and
    ``"numpy"`` (the formula, on a host without a C++ compiler)."""
    clmul, table = _native_crc.counts() if _native_crc else (0, 0)
    return {"clmul": clmul, "table": table, "numpy": _numpy_checks}


def generic_share_crc(blocks: Sequence[np.ndarray]) -> int:
    """CRC32 of one share's logical payload for q-block families: every
    block's ``pack257`` halves chained (any block of a non-systematic
    node can carry the symbol 256, so no raw-uint8 shortcut)."""
    c = 0
    for blk in blocks:
        low, hi = gf.pack257(np.asarray(blk, np.int32))
        c = zlib.crc32(np.ascontiguousarray(low, np.uint8).tobytes(), c)
        c = zlib.crc32(np.ascontiguousarray(hi, np.int64).tobytes(), c)
    return c


__all__ = ["share_crc", "share_crc_paths", "generic_share_crc"]
