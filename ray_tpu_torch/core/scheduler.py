"""Cluster resource scheduler: node selection policies + bundle placement.

Equivalent of the reference's two-level scheduler
(``src/ray/raylet/scheduling/cluster_resource_scheduler.h:96`` +
``scheduling/policy/``). Design difference: the reference keeps local truth
in each raylet with a gossiped view (ray_syncer); here the controller is the
single resource-accounting authority, so scheduling is consistent by
construction and the "spillback" path disappears. Policies implemented:

- **hybrid** (default, ``hybrid_scheduling_policy.h:50``): prefer packing
  onto non-idle feasible nodes whose critical-resource utilization is below
  ``scheduler_spread_threshold``; above it, prefer the least utilized
  (spread); pick among the top-k for tie-breaking.
- **spread** (round-robin over feasible nodes),
- **node-affinity** (hard/soft, ``scheduling_strategies.py:41``),
- **node-label** (hard/soft label matching),
- **placement-group bundles** (``bundle_scheduling_policy.h``): PACK /
  SPREAD / STRICT_PACK / STRICT_SPREAD, plus the TPU-native gang pair
  SLICE_PACK / SLICE_SPREAD.

TPU-specific: pod-slice gang placement. Every host VM of a slice
registers with the slice's id in its ``ray-tpu-slice-id`` label
(stamped by the cluster launcher / slice providers; reference:
``python/ray/_private/accelerators/tpu.py:379-382`` pins gangs via a
``TPU-{pod_type}-head`` resource — here the label IS the gang key).
``SLICE_SPREAD`` bundles land on DISTINCT ICI-connected hosts of ONE
slice; ``SLICE_PACK`` packs all bundles onto one slice's hosts with
co-residency allowed. Both are all-or-nothing: no slice admits the
whole gang → the group stays pending (never a partial reservation).
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import NodeID, PlacementGroupID
from ray_tpu_torch.core.task_spec import Bundle, PlacementGroupSpec, SchedulingStrategy

EPS = 1e-9

#: node label carrying the provider slice id: every host VM of a TPU
#: slice registers with it, so SLICE_* placement groups can gang over
#: hosts that share one ICI domain. The GCE provider's per-slice node
#: label (``ray-tpu-node-id``, one provider node == one slice) is
#: accepted as a fallback spelling.
SLICE_LABEL = "ray-tpu-slice-id"


def node_slice_id(labels: Dict[str, str]) -> Optional[str]:
    """The slice a node belongs to, or None for loose nodes."""
    return labels.get(SLICE_LABEL) or labels.get("ray-tpu-node-id")


class NodeResources:
    __slots__ = ("node_id", "total", "available", "labels", "alive", "idle",
                 "draining")

    def __init__(self, node_id: NodeID, total: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None):
        self.node_id = node_id
        self.total = dict(total)
        self.available = dict(total)
        self.labels = labels or {}
        self.alive = True
        self.idle = True
        #: autoscaler is about to terminate this node: place nothing new
        #: (reference: DrainNode RPC before termination, node_manager.cc)
        self.draining = False

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + EPS >= v for k, v in demand.items())

    def fits(self, demand: Dict[str, float]) -> bool:
        return all(self.available.get(k, 0.0) + EPS >= v for k, v in demand.items())

    def acquire(self, demand: Dict[str, float]) -> bool:
        if not self.fits(demand):
            return False
        for k, v in demand.items():
            self.available[k] = self.available.get(k, 0.0) - v
        self.idle = False
        return True

    def release(self, demand: Dict[str, float]) -> None:
        for k, v in demand.items():
            self.available[k] = min(self.total.get(k, 0.0),
                                    self.available.get(k, 0.0) + v)

    def critical_utilization(self, demand: Dict[str, float]) -> float:
        """Max over demanded resources of (used / total) — the reference's
        packing key (hybrid_scheduling_policy.cc)."""
        util = 0.0
        for k in (demand or self.total):
            t = self.total.get(k, 0.0)
            if t <= 0:
                continue
            used = t - self.available.get(k, 0.0)
            util = max(util, used / t)
        return util


class ClusterResourceScheduler:
    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: Dict[NodeID, NodeResources] = {}
        self._spread_rr = 0
        self._rng = random.Random(0)
        # pg_id -> list of (node_id, resources) actually reserved
        self._pg_reservations: Dict[PlacementGroupID, List[Tuple[NodeID, Dict[str, float]]]] = {}

    # ---- membership ----
    def add_node(self, node: NodeResources) -> None:
        with self._lock:
            self.nodes[node.node_id] = node

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            self.nodes.pop(node_id, None)

    def get_node(self, node_id: NodeID) -> Optional[NodeResources]:
        with self._lock:
            return self.nodes.get(node_id)

    # ---- selection ----
    def pick_node(self, demand: Dict[str, float],
                  strategy: SchedulingStrategy) -> Optional[NodeID]:
        """Returns the chosen node and acquires the resources, or None if
        nothing fits right now (caller queues the task)."""
        with self._lock:
            if strategy.kind == "PLACEMENT_GROUP":
                # bundle resources are pre-reserved; just pick the node
                nodes = self._pg_reservations.get(strategy.placement_group_id, [])
                if not nodes:
                    return None
                idx = strategy.placement_group_bundle_index
                if 0 <= idx < len(nodes):
                    return nodes[idx][0]
                return nodes[0][0]
            if strategy.kind == "NODE_AFFINITY":
                return self._pick_affinity(demand, strategy)
            if strategy.kind == "NODE_LABEL":
                return self._pick_label(demand, strategy)
            if strategy.kind == "SPREAD":
                return self._pick_spread(demand)
            return self._pick_hybrid(demand)

    def _alive_nodes(self) -> List[NodeResources]:
        return [n for n in self.nodes.values() if n.alive and not n.draining]

    def set_draining(self, node_id: NodeID, draining: bool) -> None:
        with self._lock:
            n = self.nodes.get(node_id)
            if n is not None:
                n.draining = draining

    def _acquire(self, node: NodeResources, demand: Dict[str, float]) -> Optional[NodeID]:
        return node.node_id if node.acquire(demand) else None

    def _pick_hybrid(self, demand: Dict[str, float]) -> Optional[NodeID]:
        cfg = get_config()
        candidates = [n for n in self._alive_nodes() if n.fits(demand)]
        if not candidates:
            return None
        below = [n for n in candidates
                 if n.critical_utilization(demand) < cfg.scheduler_spread_threshold]
        if below:
            # pack: highest utilization first (most packed feasible node)
            below.sort(key=lambda n: (-n.critical_utilization(demand), n.node_id))
            pool = below
        else:
            # spread: least utilized first
            candidates.sort(key=lambda n: (n.critical_utilization(demand), n.node_id))
            pool = candidates
        k = max(cfg.scheduler_top_k_absolute,
                int(len(pool) * cfg.scheduler_top_k_fraction))
        choice = self._rng.choice(pool[:k])
        return self._acquire(choice, demand)

    def _pick_spread(self, demand: Dict[str, float]) -> Optional[NodeID]:
        nodes = sorted(self._alive_nodes(), key=lambda n: n.node_id)
        if not nodes:
            return None
        for i in range(len(nodes)):
            n = nodes[(self._spread_rr + i) % len(nodes)]
            if n.fits(demand):
                self._spread_rr = (self._spread_rr + i + 1) % len(nodes)
                return self._acquire(n, demand)
        return None

    def _pick_affinity(self, demand, strategy) -> Optional[NodeID]:
        n = self.nodes.get(strategy.node_id)
        if n is not None and n.alive and n.fits(demand):
            return self._acquire(n, demand)
        if strategy.soft:
            return self._pick_hybrid(demand)
        return None

    def _pick_label(self, demand, strategy) -> Optional[NodeID]:
        def matches(n, labels):
            return all(n.labels.get(k) in v for k, v in labels.items())
        hard = [n for n in self._alive_nodes()
                if n.fits(demand) and matches(n, strategy.hard_labels)]
        if not hard:
            return None
        soft = [n for n in hard if matches(n, strategy.soft_labels)]
        pool = soft or hard
        pool.sort(key=lambda n: (n.critical_utilization(demand), n.node_id))
        return self._acquire(pool[0], demand)

    def release(self, node_id: NodeID, demand: Dict[str, float]) -> None:
        with self._lock:
            n = self.nodes.get(node_id)
            if n is not None:
                n.release(demand)

    def try_acquire(self, node_id: NodeID,
                    demand: Dict[str, float]) -> bool:
        """Acquire resources on a SPECIFIC node (worker-lease grants)."""
        with self._lock:
            n = self.nodes.get(node_id)
            return n is not None and n.alive and n.acquire(demand)

    def force_acquire(self, node_id: NodeID, demand: Dict[str, float]) -> None:
        """Unconditional acquisition for a resuming blocked worker: may
        drive availability transiently negative (visible backpressure that
        self-corrects as other tasks release)."""
        with self._lock:
            n = self.nodes.get(node_id)
            if n is not None:
                for k, v in demand.items():
                    n.available[k] = n.available.get(k, 0.0) - v

    # ---- placement groups (reference: bundle_scheduling_policy.h +
    # gcs_placement_group_scheduler.h 2PC; single-authority here) ----
    def reserve_placement_group(self, spec: PlacementGroupSpec) -> bool:
        """Atomically reserve all bundles, or nothing."""
        with self._lock:
            plan = self._plan_bundles(spec)
            if plan is None:
                return False
            reserved = []
            ok = True
            for bundle, node_id in plan:
                node = self.nodes[node_id]
                if node.acquire(bundle.resources):
                    reserved.append((node_id, dict(bundle.resources)))
                else:
                    ok = False
                    break
            if not ok:
                for node_id, res in reserved:
                    self.nodes[node_id].release(res)
                return False
            for (bundle, node_id) in plan:
                bundle.node_id = node_id
            self._pg_reservations[spec.pg_id] = reserved
            return True

    def _plan_bundles(self, spec: PlacementGroupSpec
                      ) -> Optional[List[Tuple[Bundle, NodeID]]]:
        nodes = self._alive_nodes()
        if spec.strategy in ("SLICE_PACK", "SLICE_SPREAD"):
            return self._plan_slice_bundles(spec, nodes)
        if spec.strategy in ("STRICT_PACK",):
            # all bundles on one node; TPU slices: prefer nodes sharing a
            # slice_id label whose head carries the gang resource.
            merged: Dict[str, float] = {}
            for b in spec.bundles:
                for k, v in b.resources.items():
                    merged[k] = merged.get(k, 0.0) + v
            for n in sorted(nodes, key=lambda n: -n.critical_utilization(merged)):
                if n.fits(merged):
                    return [(b, n.node_id) for b in spec.bundles]
            return None
        if spec.strategy == "STRICT_SPREAD":
            plan = []
            used = set()
            for b in spec.bundles:
                placed = False
                for n in sorted(nodes, key=lambda n: n.critical_utilization(b.resources)):
                    if n.node_id in used:
                        continue
                    if n.fits(b.resources):
                        plan.append((b, n.node_id))
                        used.add(n.node_id)
                        placed = True
                        break
                if not placed:
                    return None
            return plan
        # PACK (best effort single node, fall back) / SPREAD (best effort)
        plan = []
        # simulate availability so multiple bundles on one node are counted
        sim: Dict[NodeID, Dict[str, float]] = {
            n.node_id: dict(n.available) for n in nodes}

        def sim_fits(nid, res):
            av = sim[nid]
            return all(av.get(k, 0.0) + EPS >= v for k, v in res.items())

        def sim_take(nid, res):
            av = sim[nid]
            for k, v in res.items():
                av[k] = av.get(k, 0.0) - v

        prefer_pack = spec.strategy == "PACK"
        last: Optional[NodeID] = None
        for b in spec.bundles:
            order = sorted(
                nodes,
                key=lambda n: (
                    0 if (prefer_pack and n.node_id == last) else 1,
                    -n.critical_utilization(b.resources) if prefer_pack
                    else n.critical_utilization(b.resources),
                ),
            )
            placed = False
            for n in order:
                if spec.strategy == "SPREAD" and n.node_id == last and len(nodes) > 1:
                    continue
                if sim_fits(n.node_id, b.resources):
                    sim_take(n.node_id, b.resources)
                    plan.append((b, n.node_id))
                    last = n.node_id
                    placed = True
                    break
            if not placed:
                return None
        return plan

    def _plan_slice_bundles(self, spec: PlacementGroupSpec,
                            nodes: List[NodeResources]
                            ) -> Optional[List[Tuple[Bundle, NodeID]]]:
        """Gang-plan every bundle onto the hosts of ONE slice,
        all-or-nothing. SLICE_SPREAD: one bundle per DISTINCT host (a
        gang with more bundles than a slice has hosts can never use
        that slice). SLICE_PACK: first-fit over the slice's hosts,
        co-residency allowed. Slices are tried in deterministic id
        order so repeated planning under identical state picks the
        same slice."""
        groups: Dict[str, List[NodeResources]] = {}
        for n in nodes:
            sid = node_slice_id(n.labels)
            if sid:
                groups.setdefault(sid, []).append(n)
        for sid in sorted(groups):
            hosts = sorted(groups[sid], key=lambda n: n.node_id)
            if spec.strategy == "SLICE_SPREAD" and \
                    len(spec.bundles) > len(hosts):
                continue
            sim: Dict[NodeID, Dict[str, float]] = {
                n.node_id: dict(n.available) for n in hosts}
            plan: List[Tuple[Bundle, NodeID]] = []
            used: set = set()
            ok = True
            for b in spec.bundles:
                placed = False
                for n in hosts:
                    if spec.strategy == "SLICE_SPREAD" and \
                            n.node_id in used:
                        continue
                    av = sim[n.node_id]
                    if all(av.get(k, 0.0) + EPS >= v
                           for k, v in b.resources.items()):
                        for k, v in b.resources.items():
                            av[k] = av.get(k, 0.0) - v
                        plan.append((b, n.node_id))
                        used.add(n.node_id)
                        placed = True
                        break
                if not placed:
                    ok = False
                    break
            if ok:
                return plan
        return None

    def release_placement_group(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            for node_id, res in self._pg_reservations.pop(pg_id, []):
                n = self.nodes.get(node_id)
                if n is not None:
                    n.release(res)

    def pg_nodes(self, pg_id: PlacementGroupID) -> List[NodeID]:
        with self._lock:
            return [nid for nid, _ in self._pg_reservations.get(pg_id, [])]

    def bundle_labels(self, spec: PlacementGroupSpec
                      ) -> List[Dict[str, str]]:
        """Per-bundle node labels of a placed gang — the gang → mesh
        hand-off: ``ray-tpu-slice-id`` on every bundle tells the driver
        (``parallel.plan``) WHICH slice hosts the gang, so stage meshes
        and bench records can name their ICI domain."""
        with self._lock:
            out: List[Dict[str, str]] = []
            for bd in spec.bundles:
                n = self.nodes.get(bd.node_id) \
                    if bd.node_id is not None else None
                out.append(dict(n.labels) if n is not None else {})
            return out

    # ---- views ----
    def cluster_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {}
            for n in self._alive_nodes():
                for k, v in n.total.items():
                    out[k] = out.get(k, 0.0) + v
            return out

    def available_resources(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {}
            for n in self._alive_nodes():
                for k, v in n.available.items():
                    out[k] = out.get(k, 0.0) + v
            return out
