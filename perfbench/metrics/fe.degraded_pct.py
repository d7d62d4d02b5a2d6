"""fe.degraded_pct: 100 x the stripes the read front end decoded around a
missing share over the stripes its pumps read in the window
(``FrontEndMetrics.degraded_stripes`` over ``stripes_read``,
``rec.counters["fe"]``).  A program without ``stripes_read`` reads as
nothing."""


def read(rec):
    fe = rec.counters.get("fe") or {}
    if not fe.get("stripes_read"):
        return None
    return 100.0 * fe["degraded_stripes"] / fe["stripes_read"]
