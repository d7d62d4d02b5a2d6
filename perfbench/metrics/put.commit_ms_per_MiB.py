"""put.commit_ms_per_MiB: ``stage_stats()["t_commit"]``, the put's commit:
retiring the overwritten generation, installing the staged shares,
publishing the stat, in milliseconds per MiB put."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_commit", sm.put_mib(rec))
