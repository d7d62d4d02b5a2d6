"""copy.repair_ms_per_MiB: device milliseconds of host<->device copies
in the traced window per MiB of shares rebuilt."""
from perfbench import profile_reduce
from perfbench import stage_metrics as sm


def read(rec):
    if rec.trace is None or not rec.rebuilt_shares:
        return None
    ms = 1e3 * profile_reduce.seconds_where(rec.trace["by_name"], "Memcpy")
    return ms / sm.rebuilt_mib(rec)
