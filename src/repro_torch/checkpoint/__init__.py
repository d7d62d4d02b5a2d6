"""MSR-coded checkpointing of the port (``repro.checkpoint`` in the
reference): the same on-disk format, so a step saved by either package
restores bit-exactly in the other."""
from .msr_checkpoint import (SAVE_TILE_SYMBOLS, MSRCheckpointer,
                             RestoreReport, ScrubReport)

__all__ = ["MSRCheckpointer", "RestoreReport", "ScrubReport",
           "SAVE_TILE_SYMBOLS"]
