"""Sharding of the port (``repro.sharding``): the stream-axis mesh and its
rule registry (`mesh`).  The model-parallel half (`policy`, `ctx`) is not
ported yet (ROADMAP A12)."""
from . import mesh  # noqa: F401
from .mesh import (STREAM_AXIS, MeshConfigError, StreamMesh,  # noqa: F401
                   as_stream_mesh, current_mesh, use_mesh)
