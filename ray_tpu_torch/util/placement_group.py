"""Placement groups: gang resource reservations.

Equivalent of the reference's ``python/ray/util/placement_group.py`` over
the GCS placement-group manager (``gcs_placement_group_manager.h:230``,
2-phase commit scheduler ``gcs_placement_group_scheduler.h:419``). For TPU,
the slice-spanning strategies are the unit that pins a pod slice's hosts:
``SLICE_SPREAD`` gang-reserves one bundle per DISTINCT host VM of one
slice (pipeline stages / serve replicas each on their own host),
``SLICE_PACK`` packs all bundles onto one slice's hosts. Both reserve
all-or-nothing and stay PENDING until a slice with capacity exists — the
slice autoscaler (``autoscaler/slices.py``) reads pending slice gangs as
whole-slice demand. A drained/preempted slice flips its groups to
RESCHEDULING; ``ready()`` blocks again until a fresh reservation lands.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core.global_state import global_worker
from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.task_spec import Bundle, PlacementGroupSpec


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, state: str = "PENDING",
                 bundle_nodes: Optional[List[bytes]] = None,
                 bundle_labels: Optional[List[Dict[str, str]]] = None):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy
        self._state = state
        self.bundle_nodes = bundle_nodes or []
        #: per-bundle node labels of the current reservation (the
        #: gang → mesh hand-off: carries ``ray-tpu-slice-id``)
        self.bundle_labels = bundle_labels or []

    @property
    def state(self) -> str:
        """Latest known state (CREATED / PENDING / RESCHEDULING)."""
        ev = global_worker().pg_events.get(self.id.binary())
        if ev:
            self._state = ev.get("state", self._state)
        return self._state

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the group is placed (reference returns an ObjectRef;
        a blocking bool keeps the API surface minimal). A group whose
        slice drained re-enters PENDING as RESCHEDULING — ready()
        then blocks again until a fresh gang reservation lands."""
        w = global_worker()
        deadline = None if timeout is None else time.monotonic() + timeout
        with w.pg_cond:
            while True:
                ev = w.pg_events.get(self.id.binary())
                # the latest controller event wins over the cached
                # create-reply state (a RESCHEDULING notice must
                # invalidate an old CREATED)
                state = ev.get("state") if ev else self._state
                self._state = state
                if state == "CREATED":
                    if ev:
                        self.bundle_nodes = ev.get(
                            "bundle_nodes", self.bundle_nodes)
                        self.bundle_labels = ev.get(
                            "bundle_labels", self.bundle_labels)
                    return True
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                w.pg_cond.wait(timeout=min(0.2, remaining) if remaining else 0.2)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        return self.ready(timeout=timeout_seconds)

    def slice_id(self) -> Optional[str]:
        """The TPU slice hosting this gang, when every placed bundle's
        node carries the same ``ray-tpu-slice-id`` label — the handle a
        driver uses to name the ICI domain its stage meshes share
        (``parallel.plan`` logs it; benches record it). None for loose
        placements or before the gang is placed."""
        from ray_tpu_torch.core.scheduler import node_slice_id
        if not self.bundle_labels:
            return None
        ids = {node_slice_id(labels or {})
               for labels in self.bundle_labels}
        ids.discard(None)
        return ids.pop() if len(ids) == 1 else None

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy,
                                 self._state, self.bundle_nodes,
                                 self.bundle_labels))


#: the strategies the bundle planner implements
#: (core/scheduler.py::_plan_bundles)
STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD",
              "SLICE_PACK", "SLICE_SPREAD")


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown placement strategy {strategy!r} "
            f"(one of {', '.join(STRATEGIES)})")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    w = global_worker()
    spec = PlacementGroupSpec(
        pg_id=PlacementGroupID.of(w.job_id),
        bundles=[Bundle(resources=dict(b)) for b in bundles],
        strategy=strategy, name=name, creator_job=w.job_id)
    reply = w.request(P.CREATE_PG, {"spec": spec})
    return PlacementGroup(spec.pg_id, bundles, strategy,
                          state=reply["state"],
                          bundle_nodes=reply.get("bundle_nodes"),
                          bundle_labels=reply.get("bundle_labels"))


def remove_placement_group(pg: PlacementGroup) -> None:
    global_worker().request(P.REMOVE_PG, {"pg_id": pg.id.binary()})


def placement_group_table() -> List[dict]:
    return global_worker().state_query("placement_groups")
