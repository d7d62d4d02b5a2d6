"""Cluster layer of the port (``repro.cluster`` in the reference).

* `events` and `metrics` — the event model, scenario constructors and
  per-scenario accounting the object store and repair scheduler publish
  into;
* `simulator.ClusterSimulator` — an event-driven [2k, k] cluster whose
  node blocks live on the simulator's device: scenarios (node loss,
  corruption + scrub, stragglers, rack loss, rolling restarts) drive the
  fused repair engine against real encoded blocks, with repair traffic
  accounted against the RS re-download baseline and every recovery
  checked bit-exactly;
* `drills` — the crash-consistency counterpart: scripted failure
  timelines run against the real durability stack (checkpointer, store,
  scheduler, front end), asserting bit-exact resume, bounded data loss
  and zero orphans.
"""
from .drills import DRILLS, DrillResult, run_drills
from .events import (Event, Scenario, corrupt, default_layout, down, fail,
                     latent_corruption, multi_node_loss, rack_failure, read,
                     read_traffic, rolling_restart, scrub, single_node_loss,
                     slow, standard_scenarios, straggler, up)
from .metrics import LinkModel, MetricsLog
from .simulator import (DOWN, FAILED, UP, ClusterSimulator, ScenarioReport,
                        run_scenario)

__all__ = [
    "Event", "Scenario", "fail", "down", "up", "corrupt", "scrub", "slow",
    "read", "read_traffic", "single_node_loss", "multi_node_loss",
    "latent_corruption", "straggler", "rack_failure", "rolling_restart",
    "standard_scenarios", "default_layout", "LinkModel", "MetricsLog",
    "ClusterSimulator", "ScenarioReport", "run_scenario", "UP", "DOWN",
    "FAILED", "DrillResult", "DRILLS", "run_drills",
]
