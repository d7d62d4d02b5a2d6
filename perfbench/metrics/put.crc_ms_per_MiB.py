"""put.crc_ms_per_MiB: ``stage_stats()["t_crc"]``, the CRC of every share
at put time, on the pool's install threads, in thread-milliseconds per
MiB put (summed over threads, so it may overlap other stages and the
window)."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_crc", sm.put_mib(rec))
