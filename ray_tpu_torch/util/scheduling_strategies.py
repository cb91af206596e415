"""User-facing scheduling strategies (reference:
``python/ray/util/scheduling_strategies.py`` :15/:41/:135)."""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.task_spec import SchedulingStrategy


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="NODE_AFFINITY",
                                  node_id=NodeID.from_hex(self.node_id),
                                  soft=self.soft)


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[Dict[str, List[str]]] = None,
                 soft: Optional[Dict[str, List[str]]] = None):
        self.hard = hard or {}
        self.soft = soft or {}

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(kind="NODE_LABEL", hard_labels=self.hard,
                                  soft_labels=self.soft)


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks

    def to_internal(self) -> SchedulingStrategy:
        return SchedulingStrategy(
            kind="PLACEMENT_GROUP",
            placement_group_id=self.placement_group.id,
            placement_group_bundle_index=self.placement_group_bundle_index,
            placement_group_capture_child_tasks=self.placement_group_capture_child_tasks,
        )
