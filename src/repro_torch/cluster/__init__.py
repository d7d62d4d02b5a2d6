"""Cluster types of the port (``repro.cluster`` in the reference): the
event model and scenario constructors (`events`) and the per-scenario
accounting (`metrics`) the object store and repair scheduler publish
into.  The simulator and drills are not ported yet."""
from .events import (Event, Scenario, corrupt, default_layout, down, fail,
                     latent_corruption, multi_node_loss, rack_failure, read,
                     read_traffic, rolling_restart, scrub, single_node_loss,
                     slow, standard_scenarios, straggler, up)
from .metrics import LinkModel, MetricsLog

__all__ = [
    "Event", "Scenario", "fail", "down", "up", "corrupt", "scrub", "slow",
    "read", "read_traffic", "single_node_loss", "multi_node_loss",
    "latent_corruption", "straggler", "rack_failure", "rolling_restart",
    "standard_scenarios", "default_layout", "LinkModel", "MetricsLog",
]
