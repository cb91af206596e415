"""Utility libraries (reference: ``python/ray/util/``), and the metrics
registry (:mod:`ray_tpu_torch.util.metrics`)."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Queue
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
    placement_group_table,
)
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "ActorPool",
    "Queue",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
]
