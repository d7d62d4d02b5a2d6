"""Launch helpers of the port (``repro.launch`` in the reference): the
train step (`steps`), the device meshes (`mesh`), the dry run on the
meta device (`dryrun`) and its operation statistics (`op_stats`, the
counterpart of the reference's `hlo_stats`)."""
from . import mesh  # noqa: F401
from .mesh import (DeviceMesh, checked_mesh, make_host_mesh,  # noqa: F401
                   make_production_mesh, make_storage_mesh)
