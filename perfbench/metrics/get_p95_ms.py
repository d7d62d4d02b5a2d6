"""get_p95_ms: the 95th percentile (nearest rank) of the latencies of
all reads due in the window, each from when it was due to the end of the
front end pump that answered it.  A shed or failed read ranks above
every served one: it reads as the slowest served read or the whole
window, whichever is longer."""
from perfbench.stats import nearest_rank


def read(rec):
    if not rec.read_ms:
        return None
    served = [x for x in rec.read_ms if x is not None]
    worst = max(served + [rec.window_s * 1e3])
    return nearest_rank([worst if x is None else x for x in rec.read_ms],
                        0.95)
