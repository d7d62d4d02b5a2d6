"""drain.select_ms_per_MiB: ``stage_stats()["t_select"]``, the repair
scheduler's queue walk (heap, loss and helper checks, budget) and
newcomer provisioning, in milliseconds per MiB of shares rebuilt (2 S
bytes a share)."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_select", sm.rebuilt_mib(rec))
