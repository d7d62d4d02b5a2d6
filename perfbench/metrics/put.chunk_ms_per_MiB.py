"""put.chunk_ms_per_MiB: ``stage_stats()["t_chunk"]``, the put's payload
bytes cut into (T, n, S) int32 blocks (``stripes.chunk``; its nested
pack included), in milliseconds per MiB put."""
from perfbench import stage_metrics as sm


def read(rec):
    return sm.ms_per_mib(rec, "t_chunk", sm.put_mib(rec))
