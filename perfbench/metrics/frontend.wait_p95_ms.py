"""frontend.wait_p95_ms: the 95th percentile (nearest rank) over served
reads of the wait from when a read was due to the start of the front end
pump that served it: the queue in front of the front end, the
benchmark's own span."""
from perfbench.stats import nearest_rank


def read(rec):
    return nearest_rank(rec.wait_ms, 0.95) if rec.wait_ms else None
