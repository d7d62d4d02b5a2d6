"""Training of the port (``repro.train`` in the reference).

`fault_tolerance`: failure injection, heartbeats, elastic plans and the
`Supervisor` that drives a step function with checkpoint repair and
write-behind saves.  `loop`: ``train`` over the model's eager train step
(``repro_torch.launch.steps``), AdamW (``repro_torch.optim``) and the
synthetic pipeline (``repro_torch.data``), under the supervisor when a
checkpointer is given.  `tiny_lm`: the end-to-end crash drill
(``python -m repro_torch.train.tiny_lm``).
"""
from .fault_tolerance import (ClusterScheduleInjector, ElasticPlan,
                              FailureEvent, FailureInjector,
                              HeartbeatMonitor, Supervisor, plan_elastic)
from .loop import (TrainConfig, init_state, numpy_state, state_from_numpy,
                   train)

__all__ = ["FailureEvent", "FailureInjector", "ClusterScheduleInjector",
           "HeartbeatMonitor", "ElasticPlan", "plan_elastic", "Supervisor",
           "TrainConfig", "init_state", "train", "state_from_numpy",
           "numpy_state"]
