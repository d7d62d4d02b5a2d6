"""put.barrier_ms_per_MiB: ``stage_stats()["t_barrier"]``, the calling
thread waiting at the pipeline's closing barrier for the installs (CRC
and share writes) on the pool, in milliseconds per MiB put."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_barrier", sm.put_mib(rec))
