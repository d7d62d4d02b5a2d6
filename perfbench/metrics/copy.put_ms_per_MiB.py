"""copy.put_ms_per_MiB: device milliseconds of host<->device copies in
the traced window per MiB put."""
from perfbench import profile_reduce


def read(rec):
    if rec.trace is None or not rec.put_bytes:
        return None
    ms = 1e3 * profile_reduce.seconds_where(rec.trace["by_name"], "Memcpy")
    return ms / (rec.put_bytes / 2 ** 20)
