"""plan.compiles.get: plans the program's planner compiled during the
window (``plan_stats()``): first launches of a shape bucket that set-up's
warm-up did not reach."""


def read(rec):
    plan = rec.counters.get("plan")
    if plan is None or rec.reads_served == 0:
        return None
    return plan["compiles"]
