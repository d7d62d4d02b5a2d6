"""Sharding of the port (``repro.sharding``): the stream-axis mesh and its
rule registry (`mesh`), the model-parallel policy (`policy`), the
activation hints (`ctx`), placement over a (data, model) mesh (`place`)
and the model under such a mesh (`parallel`, each block kind's split
compute in `blocks`)."""
from . import mesh  # noqa: F401
from .mesh import (STREAM_AXIS, MeshConfigError, StreamMesh,  # noqa: F401
                   as_stream_mesh, current_mesh, use_mesh)
