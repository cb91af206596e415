"""StandardAutoscaler: demand-driven scale-up, idle-driven scale-down.
The port's copy of ``ray_tpu/autoscaler/autoscaler.py``.

Reference: ``python/ray/autoscaler/_private/autoscaler.py:172``
(StandardAutoscaler.update: read LoadMetrics, bin-pack pending demand
onto available node types, launch up to max, terminate idle) and
``_private/monitor.py:126`` (the loop driving update). Differences by
design: demand comes straight from the controller's ready queues and
pending placement groups (single scheduling authority — no LoadMetrics
gossip), and utilization joins on NodeID instead of ip addresses.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


class NodeTypeConfig:
    """One scalable node flavor (reference: available_node_types entries
    in the cluster YAML)."""

    def __init__(self, name: str, resources: Dict[str, float],
                 min_workers: int = 0, max_workers: int = 10):
        self.name = name
        self.resources = dict(resources)
        self.min_workers = min_workers
        self.max_workers = max_workers


def _fits(node_resources: Dict[str, float],
          demand: Dict[str, float]) -> bool:
    return all(node_resources.get(k, 0.0) >= v
               for k, v in demand.items() if v > 0)


def collect_demand_snapshot(controller) -> dict:
    """Controller-loop-thread: pending demand + per-node busyness.
    Shared by the v1 StandardAutoscaler, the v2 reconciler, and the
    SliceManager (which consumes ``slice_demand``)."""
    c = controller
    demand: List[Dict[str, float]] = []
    slice_demand: List[dict] = []
    for key, q in c.ready_queues.items():
        for tid in q:
            t = c.tasks.get(tid)
            if t is not None and t.state == "QUEUED":
                demand.append(c._sched_res(t.spec))
    for _, spec in c.pending_pgs:
        if spec.strategy in ("SLICE_PACK", "SLICE_SPREAD"):
            # slice-spanning gangs demand a WHOLE slice, not loose
            # nodes: surfaced separately so the node autoscaler never
            # launches singles for them (autoscaler/slices.py consumes)
            slice_demand.append({
                "hosts": len(spec.bundles)
                if spec.strategy == "SLICE_SPREAD" else 1,
                "bundles": [dict(b.resources) for b in spec.bundles]})
        else:
            demand.extend(b.resources for b in spec.bundles)
    busy_nodes = set()
    for lease in c.leases.values():
        busy_nodes.add(lease.node_b)
    # direct-transport worker leases create no controller lease but
    # their workers execute driver-pushed tasks — the node is busy
    for nb in getattr(c, "_lease_node", {}).values():
        busy_nodes.add(nb)
    for info in c.actors.values():
        if info.state != "DEAD" and info.node_id is not None:
            busy_nodes.add(info.node_id.binary())
    alive = {nb for nb, n in c.nodes.items() if n.alive}
    return {"demand": demand, "slice_demand": slice_demand,
            "busy_nodes": busy_nodes, "alive_nodes": alive}


def drain_node_if_idle(controller, node_b: bytes) -> bool:
    """Controller-loop-thread: mark draining unless work holds the
    node. Returns True when the node is safe to terminate."""
    return drain_nodes_if_idle(controller, [node_b])


def drain_nodes_if_idle(controller, node_bs: List[bytes]) -> bool:
    """Controller-loop-thread, slice-granular: drain ALL the given nodes
    atomically, or none — a TPU pod slice terminates as a unit, so one
    busy host VM vetoes the whole slice's termination (reference:
    DrainNode precedes termination; the gang extension is ours)."""
    from ray_tpu_torch.core.ids import NodeID
    c = controller
    targets = set(node_bs)
    busy = any(l.node_b in targets for l in c.leases.values()) \
        or any(nb in targets
               for nb in getattr(c, "_lease_node", {}).values()) \
        or any(
            info.state != "DEAD" and info.node_id is not None
            and info.node_id.binary() in targets
            for info in c.actors.values())
    if busy:
        return False
    for node_b in targets:
        c.scheduler.set_draining(NodeID(node_b), True)
    return True


class StandardAutoscaler:
    def __init__(self, controller, provider: NodeProvider,
                 node_types: List[NodeTypeConfig],
                 idle_timeout_s: float = 60.0,
                 max_launch_batch: int = 5):
        self.controller = controller
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.idle_timeout_s = idle_timeout_s
        self.max_launch_batch = max_launch_batch
        self._idle_since: Dict[str, float] = {}  # provider node id -> ts

    # ------------------------------------------------------------ update
    def update(self) -> Dict[str, Any]:
        """One reconcile pass; returns what it did (for tests/monitor
        logs). Reference: StandardAutoscaler.update."""
        snap = self.controller.call_on_loop(self._snapshot)
        launched = self._scale_up(snap)
        terminated = self._scale_down(snap)
        return {"launched": launched, "terminated": terminated,
                "pending_demand": len(snap["demand"])}

    def _snapshot(self) -> dict:
        return collect_demand_snapshot(self.controller)

    def _provider_nodes_by_type(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {name: [] for name in self.node_types}
        for nid in self.provider.non_terminated_nodes():
            out.setdefault(self.provider.node_type(nid), []).append(nid)
        return out

    def _scale_up(self, snap: dict) -> List[str]:
        """First-fit bin-pack unplaceable demand onto hypothetical new
        nodes (reference: resource_demand_scheduler.get_nodes_to_launch,
        simplified to first-fit like its binpacking core)."""
        by_type = self._provider_nodes_by_type()
        launched: List[str] = []
        # eagerly maintain min_workers (reference: the autoscaler launches
        # to min_workers even with zero demand)
        for t in self.node_types.values():
            while len(by_type.get(t.name, ())) + \
                    sum(1 for x in launched
                        if self.provider.node_type(x) == t.name) \
                    < t.min_workers:
                launched.append(self.provider.create_node(
                    t.name, t.resources))
        demand = [d for d in snap["demand"] if d]
        if not demand:
            return launched
        planned: List[NodeTypeConfig] = []
        # capacity already launched but not yet registered (starting
        # nodes are invisible to the scheduler, so queued demand they
        # will absorb must not trigger duplicate launches)
        planned_room: List[Dict[str, float]] = [
            dict(self.provider.node_resources(nid))
            for nids in by_type.values() for nid in nids
            if not any(i in snap["alive_nodes"]
                       for i in self.provider.internal_ids(nid))]
        for d in demand:
            placed = False
            for room in planned_room:
                if _fits(room, d):
                    for k, v in d.items():
                        room[k] = room.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for t in self.node_types.values():
                existing = len(by_type.get(t.name, ()))
                already = sum(1 for p in planned if p.name == t.name)
                if existing + already >= t.max_workers:
                    continue
                if _fits(t.resources, d):
                    planned.append(t)
                    room = dict(t.resources)
                    for k, v in d.items():
                        room[k] = room.get(k, 0.0) - v
                    planned_room.append(room)
                    break
            # demand no type can satisfy is skipped (the reference logs
            # an infeasible warning; scheduler keeps it queued)
        for t in planned[:self.max_launch_batch]:
            nid = self.provider.create_node(t.name, t.resources)
            logger.info("autoscaler: launched %s (%s)", nid, t.name)
            launched.append(nid)
        return launched

    def _scale_down(self, snap: dict) -> List[str]:
        now = time.monotonic()
        terminated = []
        by_type = self._provider_nodes_by_type()
        for t in self.node_types.values():
            nodes = by_type.get(t.name, [])
            for nid in nodes:
                internals = self.provider.internal_ids(nid)
                # a multi-host slice has joined when EVERY expected host
                # VM is alive (partially-joined slices are still
                # starting); one busy host makes the whole slice busy —
                # slices terminate as a unit
                joined = len(internals) >= \
                    self.provider.expected_internal_count(nid) and \
                    bool(internals) and all(
                        i in snap["alive_nodes"] for i in internals)
                busy = any(i in snap["busy_nodes"] for i in internals)
                if busy or not joined:
                    # not-yet-joined nodes are starting up, not idle
                    self._idle_since.pop(nid, None)
                    continue
                since = self._idle_since.setdefault(nid, now)
                if now - since < self.idle_timeout_s:
                    continue
                if len(nodes) - len([x for x in terminated
                                     if x in nodes]) <= t.min_workers:
                    continue
                # drain atomically on the controller loop: mark every
                # host unschedulable iff all are still idle (reference:
                # DrainNode precedes termination) — closes the race
                # where a lease lands between our snapshot and the
                # SIGTERM, and keeps slice termination all-or-nothing
                if not self.controller.call_on_loop(
                        lambda ids=internals:
                        drain_nodes_if_idle(self.controller, ids)):
                    self._idle_since.pop(nid, None)
                    continue
                logger.info("autoscaler: terminating idle node %s", nid)
                self.provider.terminate_node(nid)
                self._idle_since.pop(nid, None)
                terminated.append(nid)
        return terminated


class AutoscalerMonitor:
    """Background loop driving update() (reference: monitor.py:126).
    Drives anything with an ``update()`` — v1, v2, or a SliceManager.

    Every wait goes through the stop Event (never a bare
    ``time.sleep``), so :meth:`stop` interrupts a sleeping loop
    promptly. Repeated ``update()`` failures back off with the shared
    jittered exponential (``util/backoff.py``) instead of hammering a
    broken provider at the fixed interval; one success resets it."""

    def __init__(self, autoscaler,
                 interval_s: float = 5.0):
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        from ray_tpu_torch.util.backoff import ExponentialBackoff
        # equal jitter keeps a floor of interval/2 — a failing pass
        # must never retry faster than a healthy one polls
        self._backoff = ExponentialBackoff(
            base=max(0.1, interval_s), cap=max(60.0, interval_s),
            jitter="equal")

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler-monitor", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        delay = self.interval_s
        while not self._stop.wait(delay):
            try:
                self.autoscaler.update()
            except Exception:
                logger.exception("autoscaler update failed")
                delay = self._backoff.next_delay()
            else:
                self._backoff.reset()
                delay = self.interval_s

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
