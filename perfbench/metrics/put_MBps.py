"""put_MBps: user bytes acknowledged by put per second of the window."""


def read(rec):
    if not rec.puts:
        return None
    return rec.put_bytes / rec.window_s / 1e6
