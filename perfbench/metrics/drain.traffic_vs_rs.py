"""drain.traffic_vs_rs: repair traffic over what a Reed-Solomon store
would download for the same shares, summed over the window's drain
ticks (``DrainReport``): (k+1)/(2k) = 9/16 when every lost share is
regenerated from its d = k+1 helpers."""


def read(rec):
    base = rec.drain.get("rs_baseline_symbols")
    if not base:
        return None
    return rec.drain["symbols_moved"] / base
