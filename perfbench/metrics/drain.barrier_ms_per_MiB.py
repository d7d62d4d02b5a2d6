"""drain.barrier_ms_per_MiB: ``stage_stats()["t_barrier"]``, the calling
thread waiting at the pipeline's closing barrier for the rebuilt shares'
installs, in milliseconds per MiB of shares rebuilt (2 S bytes a share)."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_barrier", sm.rebuilt_mib(rec))
