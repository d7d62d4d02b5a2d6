"""Training control plane of the port (``repro.train`` in the reference).

Only `fault_tolerance` is ported: failure injection, heartbeats, elastic
plans and the `Supervisor` that drives a caller's step function with
checkpoint repair and write-behind saves.  The model stack's serving
path is ported (`repro_torch.models`, `repro_torch.serve.engine`); the
training loop (``train/loop.py``) with ``Model.loss``, the optimizers and
the data pipeline is not ported yet.
"""
from .fault_tolerance import (ClusterScheduleInjector, ElasticPlan,
                              FailureEvent, FailureInjector,
                              HeartbeatMonitor, Supervisor, plan_elastic)

__all__ = ["FailureEvent", "FailureInjector", "ClusterScheduleInjector",
           "HeartbeatMonitor", "ElasticPlan", "plan_elastic", "Supervisor"]
