"""Small statistics shared by the metric readers and the spread tool."""
from __future__ import annotations

import math
import statistics


def nearest_rank(values: list, q: float):
    """The q-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a q share of the values at or below it."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def spread(values: list[float]) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles``, n=4) as a share of the median."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


__all__ = ["nearest_rank", "spread"]
