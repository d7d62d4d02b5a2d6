"""frontend.service_ms: wall milliseconds of front end pumps per read
served in the window."""


def read(rec):
    if not rec.reads_served:
        return None
    return 1e3 * rec.pump_s / rec.reads_served
