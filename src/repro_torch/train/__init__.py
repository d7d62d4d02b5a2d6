"""Training control plane of the port (``repro.train`` in the reference).

Only `fault_tolerance` is ported: failure injection, heartbeats, elastic
plans and the `Supervisor` that drives a caller's step function with
checkpoint repair and write-behind saves.  The training loop over the
model stack (``train/loop.py``) is not ported yet.
"""
from .fault_tolerance import (ClusterScheduleInjector, ElasticPlan,
                              FailureEvent, FailureInjector,
                              HeartbeatMonitor, Supervisor, plan_elastic)

__all__ = ["FailureEvent", "FailureInjector", "ClusterScheduleInjector",
           "HeartbeatMonitor", "ElasticPlan", "plan_elastic", "Supervisor"]
