"""Model configurations of the port (``repro.configs`` in the reference):
`ModelConfig`, the shape suite and the architecture registry, data only
and field for field the reference's."""
from .base import ModelConfig, ShapeConfig, SHAPES  # noqa: F401
from .registry import ARCH_IDS, get_config, get_shape, cells, skipped_cells  # noqa: F401
