"""Execution layer of the port: the shape-bucketed plan cache
(`repro_torch.exec.plan`) and pinned host staging
(`repro_torch.exec.staging`)."""
from .plan import (PlanCache, PlanResult, PlanStats, bucket_symbols,
                   clear_planners, get_planner, plan_stats,
                   planning_disabled, planning_enabled, reset_plan_stats,
                   set_planning)

__all__ = [
    "PlanCache", "PlanResult", "PlanStats", "bucket_symbols",
    "get_planner", "plan_stats", "reset_plan_stats", "clear_planners",
    "set_planning", "planning_enabled", "planning_disabled",
]
