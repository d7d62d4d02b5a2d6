"""Execution layer of the port: the shape-bucketed plan cache
(`repro_torch.exec.plan`), pinned host staging
(`repro_torch.exec.staging`) and the overlapped read → compute → consume
pipeline (`repro_torch.exec.pipeline`)."""
from .pipeline import Pipeline
from .plan import (PlanCache, PlanResult, PlanStats, bucket_symbols,
                   clear_planners, get_planner, plan_stats,
                   planning_disabled, planning_enabled, reset_plan_stats,
                   set_planning)

__all__ = [
    "Pipeline", "PlanCache", "PlanResult", "PlanStats", "bucket_symbols",
    "get_planner", "plan_stats", "reset_plan_stats", "clear_planners",
    "set_planning", "planning_enabled", "planning_disabled",
]
