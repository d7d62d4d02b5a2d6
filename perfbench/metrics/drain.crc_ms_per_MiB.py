"""drain.crc_ms_per_MiB: ``stage_stats()["t_crc"]``, the CRC of every
helper share the repair gather verifies, in thread-milliseconds per MiB
of shares rebuilt (summed over threads: the gather runs on the pool)."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_crc", sm.rebuilt_mib(rec))
