"""fe.fetch_ms_per_MiB: ``stage_stats()["t_fe_fetch"]``, the read front
end's per-stripe share fetches, hedges and CRC checks on the dispatcher
thread, in milliseconds per MiB of reads served (each read its object's
bytes, ``rec.counters["reads"]["bytes"]``).  A program without the stage
reads as nothing."""
from perfbench import stage_metrics as sm


def read(rec):
    served = (rec.counters.get("reads") or {}).get("bytes", 0)
    return sm.ms_per_mib(rec, "t_fe_fetch", served / 2 ** 20)
