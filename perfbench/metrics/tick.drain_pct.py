"""tick.drain_pct: 100 x ``stage_stats()["t_tick_drain"]`` over the
window: the share of the dispatcher thread's time that the read front
end's ``tick`` spends in its repair scheduler drain.  A program without
the stage reads as nothing."""


def read(rec):
    stage = rec.counters.get("stage") or {}
    if "t_tick_drain" not in stage or not rec.window_s:
        return None
    return 100.0 * stage["t_tick_drain"] / rec.window_s
