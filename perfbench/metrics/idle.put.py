"""The device's idle share of the traced window in percent: 100 less
the union of its kernel, copy and set intervals over the window."""


def read(rec):
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
