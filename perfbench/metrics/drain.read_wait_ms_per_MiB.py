"""drain.read_wait_ms_per_MiB: ``stage_stats()["t_read_wait"]``, the
calling thread blocked on a window's verified helper gather (the
pipeline's read) on the pool, in milliseconds per MiB of shares rebuilt
(2 S bytes a share)."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_read_wait", sm.rebuilt_mib(rec))
