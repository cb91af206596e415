"""Autoscaler v2: instance-lifecycle reconciliation.

Reference: ``python/ray/autoscaler/v2/`` — ``instance_manager/``
(Instance protos with a QUEUED→REQUESTED→ALLOCATED→RAY_RUNNING→
RAY_STOPPING→TERMINATED state machine behind InstanceStorage) and
``scheduler.py`` (ResourceDemandScheduler computing launch/terminate
decisions from the cluster resource state the GCS aggregates). The v1
StandardAutoscaler mutates the provider imperatively inside update();
v2 separates DESIRED state (instances + their lifecycle) from
OBSERVED state (provider + controller), and a reconciler converges
them — restartable, inspectable, and testable at each transition.

The port's copy of ``ray_tpu/autoscaler/v2.py``, over the port's
``autoscaler.py::_fits`` and ``NodeProvider`` (node types count their
CUDA devices as ``GPU``).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig, _fits
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)

# Instance lifecycle (reference: instance_manager.proto Instance.Status)
QUEUED = "QUEUED"                # decided to launch; not yet requested
REQUESTED = "REQUESTED"          # provider.create_node issued
ALLOCATED = "ALLOCATED"          # provider reports the node exists
RAY_RUNNING = "RAY_RUNNING"      # node manager registered with controller
RAY_STOPPING = "RAY_STOPPING"    # drain requested
TERMINATING = "TERMINATING"      # provider.terminate_node issued
TERMINATED = "TERMINATED"

_TRANSITIONS = {
    QUEUED: {REQUESTED, TERMINATED},
    REQUESTED: {ALLOCATED, TERMINATED},
    ALLOCATED: {RAY_RUNNING, TERMINATING},
    RAY_RUNNING: {RAY_STOPPING, TERMINATING},
    RAY_STOPPING: {TERMINATING},
    TERMINATING: {TERMINATED},
    TERMINATED: set(),
}


@dataclass
class Instance:
    instance_id: str
    node_type: str
    status: str = QUEUED
    provider_node_id: Optional[str] = None
    ray_node_id: Optional[bytes] = None
    launched_at: float = field(default_factory=time.monotonic)
    updated_at: float = field(default_factory=time.monotonic)
    history: List[str] = field(default_factory=list)


class InstanceStorage:
    """In-memory instance table with transition validation (reference:
    ``instance_manager/instance_storage.py``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}

    def add(self, node_type: str) -> Instance:
        inst = Instance(instance_id=uuid.uuid4().hex[:12],
                        node_type=node_type)
        inst.history.append(QUEUED)
        with self._lock:
            self._instances[inst.instance_id] = inst
        return inst

    def transition(self, instance_id: str, new_status: str, **updates) -> bool:
        with self._lock:
            inst = self._instances.get(instance_id)
            if inst is None:
                return False
            if new_status not in _TRANSITIONS.get(inst.status, ()):
                logger.warning("invalid transition %s: %s -> %s",
                               instance_id, inst.status, new_status)
                return False
            inst.status = new_status
            inst.updated_at = time.monotonic()
            inst.history.append(new_status)
            for k, v in updates.items():
                setattr(inst, k, v)
            return True

    def list(self, *statuses: str) -> List[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if statuses:
            out = [i for i in out if i.status in statuses]
        return out

    def get(self, instance_id: str) -> Optional[Instance]:
        with self._lock:
            return self._instances.get(instance_id)


class ResourceDemandScheduler:
    """Pure function: (demand, instances, node_types) -> decisions
    (reference: ``v2/scheduler.py`` ResourceDemandScheduler)."""

    def __init__(self, node_types: Dict[str, NodeTypeConfig]):
        self.node_types = node_types

    def schedule(self, demands: List[Dict[str, float]],
                 instances: List[Instance],
                 idle_ray_nodes: List[str]) -> Dict[str, Any]:
        """Returns {"launch": {node_type: n}, "terminate": [instance_id]}."""
        active = [i for i in instances
                  if i.status in (QUEUED, REQUESTED, ALLOCATED,
                                  RAY_RUNNING)]
        # In-flight capacity absorbs demand before new launches: nodes
        # already requested/allocating will join and take queued work.
        # RAY_RUNNING nodes do NOT count — the cluster scheduler already
        # placed what fits on them; queued demand is by definition what
        # they could not hold.
        free: List[Dict[str, float]] = []
        for i in active:
            if i.status == RAY_RUNNING:
                continue
            t = self.node_types.get(i.node_type)
            if t is not None:
                free.append(dict(t.resources))
        unmet: List[Dict[str, float]] = []
        for d in demands:
            placed = False
            for cap in free:
                if _fits(cap, d):
                    for k, v in d.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if not placed:
                unmet.append(d)

        launch: Dict[str, int] = {}
        counts: Dict[str, int] = {}
        for i in active:
            counts[i.node_type] = counts.get(i.node_type, 0) + 1
        # bin-pack unmet demand into PLANNED launches first: ten 1-CPU
        # demands fill one 8-CPU node, not ten (v1 planned_room parity)
        planned_room: List[Dict[str, float]] = []
        for d in unmet:
            placed = False
            for room in planned_room:
                if _fits(room, d):
                    for k, v in d.items():
                        room[k] = room.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for name, t in self.node_types.items():
                total = counts.get(name, 0) + launch.get(name, 0)
                if _fits(t.resources, d) and total < t.max_workers:
                    launch[name] = launch.get(name, 0) + 1
                    room = dict(t.resources)
                    for k, v in d.items():
                        room[k] = room.get(k, 0.0) - v
                    planned_room.append(room)
                    break
        # min_workers floor
        for name, t in self.node_types.items():
            total = counts.get(name, 0) + launch.get(name, 0)
            if total < t.min_workers:
                launch[name] = launch.get(name, 0) + \
                    (t.min_workers - total)

        # idle RAY_RUNNING instances above the floor may terminate
        terminate: List[str] = []
        if not demands:
            by_type: Dict[str, List[Instance]] = {}
            for i in active:
                if i.status == RAY_RUNNING:
                    by_type.setdefault(i.node_type, []).append(i)
            idle = set(idle_ray_nodes)
            for name, insts in by_type.items():
                t = self.node_types.get(name)
                floor = t.min_workers if t else 0
                killable = [i for i in insts
                            if i.provider_node_id in idle]
                for i in killable[:max(0, len(insts) - floor)]:
                    terminate.append(i.instance_id)
        return {"launch": launch, "terminate": terminate}


class AutoscalerV2:
    """The reconciler: observe -> decide -> converge (reference:
    ``v2/autoscaler.py`` + ``instance_manager/reconciler.py``)."""

    def __init__(self, controller, provider: NodeProvider,
                 node_types: List[NodeTypeConfig],
                 idle_timeout_s: float = 60.0,
                 slice_manager=None):
        self.controller = controller
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.storage = InstanceStorage()
        self.scheduler = ResourceDemandScheduler(self.node_types)
        self.idle_timeout_s = idle_timeout_s
        self._idle_since: Dict[str, float] = {}
        #: optional slice-granular layer (autoscaler/slices.py): the
        #: reconciler hands it the same demand snapshot each pass, so
        #: unplaceable SLICE_* placement groups demand whole slices
        #: and idle slices scale down as a unit
        self.slice_manager = slice_manager

    # -------------------------------------------------------- reconcile
    def update(self) -> Dict[str, Any]:
        from ray_tpu_torch.autoscaler.autoscaler import (
            collect_demand_snapshot, drain_nodes_if_idle)
        snap = self.controller.call_on_loop(
            lambda: collect_demand_snapshot(self.controller))
        provider_nodes = set(self.provider.non_terminated_nodes())

        # 0. adopt provider nodes we didn't launch (head-start nodes,
        # restarts of this reconciler) — slices the slice layer owns
        # stay out of the node-granular books: their lifecycle (and
        # SLICE_* flight events) belongs to the SliceManager alone
        known = {i.provider_node_id for i in self.storage.list()}
        if self.slice_manager is not None:
            known |= set(self.slice_manager.slices)
        for pid in provider_nodes - known:
            inst = self.storage.add(self.provider.node_type(pid))
            self.storage.transition(inst.instance_id, REQUESTED,
                                    provider_node_id=pid)

        # 1. sync instance states with observation
        for inst in self.storage.list(REQUESTED):
            if inst.provider_node_id in provider_nodes:
                self.storage.transition(inst.instance_id, ALLOCATED)
        for inst in self.storage.list(ALLOCATED):
            # slice-granular join: every expected host VM must be alive
            # (a multi-host slice is RAY_RUNNING only when whole)
            ids = self.provider.internal_ids(inst.provider_node_id)
            if ids and len(ids) >= self.provider.expected_internal_count(
                    inst.provider_node_id) and all(
                    i in snap["alive_nodes"] for i in ids):
                self.storage.transition(inst.instance_id, RAY_RUNNING,
                                        ray_node_id=ids[0])
        for inst in self.storage.list(REQUESTED, ALLOCATED, RAY_RUNNING):
            if inst.provider_node_id is not None and \
                    inst.provider_node_id not in provider_nodes:
                # the node vanished under us: walk only the legal
                # transitions from wherever it currently is
                if inst.status == REQUESTED:
                    self.storage.transition(inst.instance_id, TERMINATED)
                elif inst.status == ALLOCATED:
                    self.storage.transition(inst.instance_id, TERMINATING)
                    self.storage.transition(inst.instance_id, TERMINATED)
                else:  # RAY_RUNNING
                    self.storage.transition(inst.instance_id, TERMINATING)
                    self.storage.transition(inst.instance_id, TERMINATED)

        # 2. idle tracking for scale-down
        now = time.monotonic()
        idle = []
        for inst in self.storage.list(RAY_RUNNING):
            pid = inst.provider_node_id
            ids = self.provider.internal_ids(pid)
            if ids and all(i in snap["alive_nodes"] for i in ids) \
                    and not any(i in snap["busy_nodes"] for i in ids) \
                    and not snap["demand"]:
                since = self._idle_since.setdefault(pid, now)
                if now - since >= self.idle_timeout_s:
                    idle.append(pid)
            else:
                self._idle_since.pop(pid, None)

        # 3. decide
        decisions = self.scheduler.schedule(
            snap["demand"], self.storage.list(), idle)

        # 4. converge
        launched = []
        for node_type, n in decisions["launch"].items():
            t = self.node_types[node_type]
            for _ in range(n):
                inst = self.storage.add(node_type)
                try:
                    pid = self.provider.create_node(node_type,
                                                    t.resources)
                except Exception:
                    logger.exception("create_node failed")
                    self.storage.transition(inst.instance_id, TERMINATED)
                    continue
                self.storage.transition(inst.instance_id, REQUESTED,
                                        provider_node_id=pid)
                launched.append(inst.instance_id)
        terminated = []
        for iid in decisions["terminate"]:
            inst = self.storage.get(iid)
            if inst is None or inst.status != RAY_RUNNING:
                continue
            # drain ALL host VMs of the slice atomically on the
            # controller loop (DrainNode before termination — same
            # race-closure as v1; one busy host vetoes the slice)
            all_ids = self.provider.internal_ids(inst.provider_node_id) \
                or ([inst.ray_node_id] if inst.ray_node_id else [])
            if all_ids and not self.controller.call_on_loop(
                    lambda ids=all_ids:
                    drain_nodes_if_idle(self.controller, ids)):
                self._idle_since.pop(inst.provider_node_id, None)
                continue
            if self.storage.transition(iid, RAY_STOPPING):
                self.storage.transition(iid, TERMINATING)
                try:
                    self.provider.terminate_node(inst.provider_node_id)
                except Exception:
                    logger.exception("terminate_node failed")
                self.storage.transition(iid, TERMINATED)
                self._idle_since.pop(inst.provider_node_id, None)
                terminated.append(iid)
        out = {"launched": launched, "terminated": terminated,
               "instances": {i.instance_id: i.status
                             for i in self.storage.list()}}
        # 5. slice-granular layer: gang demand -> whole slices
        if self.slice_manager is not None:
            out["slices"] = self.slice_manager.update(snap=snap)
        return out
