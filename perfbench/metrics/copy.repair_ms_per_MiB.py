"""copy.repair_ms_per_MiB: device milliseconds of host<->device copies
in the traced window per MiB of shares rebuilt (2 S bytes a share)."""
from perfbench import profile_reduce


def read(rec):
    if rec.trace is None or not rec.rebuilt_shares:
        return None
    ms = 1e3 * profile_reduce.seconds_where(rec.trace["by_name"], "Memcpy")
    return ms / (rec.rebuilt_shares * 2 * rec.code["S"] / 2 ** 20)
