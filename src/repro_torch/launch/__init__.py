"""Launch helpers of the port (``repro.launch`` in the reference): the
train step (`steps`) and the device meshes (`mesh`).  The dry run and the
HLO statistics wait for ROADMAP A15."""
from . import mesh  # noqa: F401
from .mesh import (DeviceMesh, checked_mesh, make_host_mesh,  # noqa: F401
                   make_production_mesh, make_storage_mesh)
