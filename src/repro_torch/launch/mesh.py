"""Production meshes (the port of ``repro.launch.mesh``).  Defined as
FUNCTIONS so importing this module never touches device state.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model).

Each constructor returns a :class:`DeviceMesh` — ``.shape`` a dict from
axis name to size and ``.devices`` an object array of ``torch.device``s,
as a ``jax.sharding.Mesh`` has — validated by :func:`checked_mesh`, which
raises the typed :class:`~repro_torch.sharding.mesh.MeshConfigError`
naming the fix.  ``devices=None`` draws from the host's CUDA cards;
``devices=`` places the mesh explicitly and may repeat a device (the CPU
tests pass ``["cpu"] * n``).  The storage layer's 1-D stream mesh is
:class:`~repro_torch.sharding.mesh.StreamMesh`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import canonical_device
from repro_torch.sharding.mesh import MeshConfigError


class DeviceMesh:
    """A named grid of devices: ``shape`` {axis: size} in axis order and
    ``devices`` an object array of that shape."""

    def __init__(self, devices: np.ndarray, axes: tuple[str, ...]):
        self.devices = devices
        self.shape = dict(zip(axes, devices.shape))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeviceMesh({self.shape})"


def checked_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                 devices=None) -> DeviceMesh:
    """A :class:`DeviceMesh` with typed validation: every axis size a
    positive int, one distinct name per axis, and the total device
    product available (the first ``prod(shape)`` of ``devices``, or of
    the CUDA cards when ``devices`` is None)."""
    if len(shape) != len(axes):
        raise MeshConfigError(
            f"mesh shape {shape} has {len(shape)} axes but {len(axes)} "
            f"names {axes}")
    if len(set(axes)) != len(axes):
        raise MeshConfigError(f"duplicate mesh axis names: {axes}")
    for size, name in zip(shape, axes):
        if isinstance(size, bool) or not isinstance(size, int) or size < 1:
            raise MeshConfigError(
                f"mesh axis {name!r} must have a positive int size, "
                f"got {size!r}")
    want = math.prod(shape)
    if devices is None:
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        where = "CUDA cards"
    else:
        pool = [canonical_device(d) for d in devices]
        where = "devices given"
    if want > len(pool):
        raise MeshConfigError(
            f"mesh {dict(zip(axes, shape))} needs {want} devices but only "
            f"{len(pool)} {where}; pass devices= to place it explicitly "
            f"(a device may repeat)")
    grid = np.empty(want, dtype=object)
    grid[:] = pool[:want]
    return DeviceMesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return checked_mesh(shape, axes, devices)


def make_storage_mesh(n_nodes: int, devices=None):
    """1-D ring mesh for the MSR storage layer (the ring encode runs
    neighbour-wise over this axis)."""
    return checked_mesh((n_nodes,), ("storage",), devices)


def make_host_mesh(devices=None):
    """Whatever this host offers (or ``devices``): a 1-D data mesh."""
    n = torch.cuda.device_count() if devices is None else len(devices)
    if n == 0:
        raise MeshConfigError("this host has no CUDA card; pass devices= "
                              "(e.g. devices=['cpu'] * 4)")
    return checked_mesh((n,), ("data",), devices)


__all__ = ["DeviceMesh", "checked_mesh", "make_production_mesh",
           "make_storage_mesh", "make_host_mesh"]
