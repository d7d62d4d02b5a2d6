"""Where the port computes.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA card, and asking for CUDA on a host without one raises —
the port never falls back to the CPU on its own.  Callers that want the
CPU (the CPU tests) say ``device="cpu"``.  A tensor argument carries its
own device, which wins over the ``device`` argument.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``"cuda"``.

    Raises RuntimeError for a CUDA device when CUDA is unavailable.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the port runs on the card "
            "by default — pass device='cpu' to compute on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """:func:`resolve_device` of ``device`` with a CUDA device's index
    filled in (``"cuda"`` is the current card), so that two names of one
    device compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(*xs, device=None) -> torch.device:
    """The device of the first tensor among ``xs``, else
    :func:`resolve_device` of ``device``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(device)


def as_int32(x, p: int, device: torch.device) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested list of integers) as a
    contiguous int32 tensor on ``device``.

    Dtypes wider than 16 bits other than int32 are reduced mod p first so
    the cast cannot wrap; narrower ones cast exactly.  Values are not
    otherwise reduced: the kernels and their plain versions reduce their
    inputs mod p themselves.
    """
    if isinstance(x, torch.Tensor):
        t = x
        if t.dtype != torch.int32:
            if t.dtype.is_floating_point or t.dtype == torch.bool:
                raise TypeError(f"GF symbols must be integers, got {t.dtype}")
            if t.element_size() > 2:
                t = torch.remainder(t.to(torch.int64), p)
            t = t.to(torch.int32)
    else:
        a = np.asarray(x)
        if a.dtype.kind not in "iu":
            raise TypeError(f"GF symbols must be integers, got {a.dtype}")
        if a.dtype != np.int32:
            if a.dtype.itemsize > 2:
                a = np.remainder(a.astype(np.int64), p)
            a = a.astype(np.int32)
        if not a.flags.writeable:       # torch tensors are always writable
            a = a.copy()
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device).contiguous()


__all__ = ["resolve_device", "canonical_device", "device_of", "as_int32"]
