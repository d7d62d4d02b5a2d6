"""tick.pump_pct: 100 x ``stage_stats()["t_tick_pump"]`` over the
window: the share of the dispatcher thread's time that the read front
end's ``tick`` spends pumping the reads admitted.  A program without the
stage reads as nothing."""


def read(rec):
    stage = rec.counters.get("stage") or {}
    if "t_tick_pump" not in stage or not rec.window_s:
        return None
    return 100.0 * stage["t_tick_pump"] / rec.window_s
