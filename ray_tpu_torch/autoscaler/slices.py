"""Slice-granular gang scheduling: the SliceManager. The port's copy of
``ray_tpu/autoscaler/slices.py``, wired to the port's runtime hooks
(``core/scheduler.py``'s ``SLICE_LABEL`` and ``set_draining``, the
controller's ``_reschedule_pgs_on_nodes``, ``core/chaos.py``'s
``maintenance`` schedule, the ``SLICE_*`` events and gauges); a slice is
a gang of hosts of the port's nodes; it composes with the v2
autoscaler (``v2.py``) as in the JAX package.

A TPU pod slice is the atomic multi-host unit everything multi-host
rides on: its host VMs share one ICI domain, come up together, and are
preempted together (maintenance events hit the slice, not a VM).
Nothing below this layer can acquire "4 hosts that can talk" — only a
slice can. The reference splits this between the GCS placement-group
manager (gang bundles) and the autoscaler's TPU pod handling
(``python/ray/_private/accelerators/tpu.py`` gang resources +
``gcp/node.py`` slice provisioning); here one controller-side manager
owns the whole lifecycle:

- **acquire**: :meth:`SliceManager.acquire_slice` asks the provider
  (``NodeProvider.create_slice`` — GCE/GKE/Fake) for a whole slice;
  the slice is ``REQUESTED`` until every host VM registers with the
  controller carrying the slice's id in its ``ray-tpu-slice-id``
  label, then ``UP`` (flight-recorder ``SLICE_UP``).
- **gang placement**: pending ``SLICE_PACK``/``SLICE_SPREAD``
  placement groups (``util/placement_group.py``) are whole-slice
  demand — :func:`plan_slice_scaling` converts them into acquire
  decisions; the bundle planner
  (``core/scheduler.py::_plan_slice_bundles``) then reserves all
  bundles across the slice's distinct hosts all-or-nothing.
- **preemption-aware drain**: provider ``maintenance_events`` (real
  upcoming-maintenance notices, or simulated ones from the chaos
  harness — ``ChaosConfig.maintenance``) flip the slice to
  ``DRAINING`` (``SLICE_DRAIN``): its hosts stop taking leases
  (scheduler draining flag), its placement groups are torn down and
  re-queued (``Controller._reschedule_pgs_on_nodes`` →
  ``RESCHEDULING`` → a fresh slice), and after the drain window (or
  ``drain_deadline_s``, so a stuck workload can never hang the
  release) the slice is deleted and its hosts declared dead
  (``SLICE_DOWN`` with the drain duration; in-flight actor calls
  surface typed ``ActorUnavailableError`` and restart on the new
  reservation).
- **scale-down as a unit**: an idle slice (no leases/actors on ANY
  host past ``idle_timeout_s``) drains atomically —
  ``drain_nodes_if_idle`` vetoes if one host got busy — and is
  released whole.

Fleet gauges (``core/metric_defs.py``): ``autoscaler_slices_up``,
``autoscaler_slice_hosts_pending``, ``autoscaler_slice_drain_seconds``.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider, SliceCapacityError)
from ray_tpu_torch.core.scheduler import SLICE_LABEL  # noqa: F401 (re-export)

logger = logging.getLogger(__name__)

# slice lifecycle (a deliberate miniature of the v2 instance machine:
# a slice is REQUESTED until whole, never partially UP)
REQUESTED = "REQUESTED"
UP = "UP"
DRAINING = "DRAINING"
RELEASED = "RELEASED"


def hosts_for_topology(topology: str, chips_per_host: int = 4) -> int:
    """Host-VM count of a TPU slice topology string (``"2x2"``,
    ``"4x4"``, ``"2x2x4"``): chips = the product of the axes, 4 chips
    per host VM (the v4/v5p host layout), minimum one host. Unknown
    strings raise ``ValueError`` — a topology typo must fail at config
    validation, not at provisioning time."""
    if not isinstance(topology, str):
        raise ValueError(
            f"slice topology must be a string like '2x2', got "
            f"{type(topology).__name__}")
    parts = topology.strip().lower().split("x")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"unknown slice topology {topology!r}: expected 'AxB' or "
            f"'AxBxC' (chip axes, e.g. '2x2', '4x4', '2x2x4')")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"unknown slice topology {topology!r}: axes must be "
            f"integers") from None
    if any(d <= 0 for d in dims):
        raise ValueError(
            f"unknown slice topology {topology!r}: axes must be "
            f"positive")
    chips = math.prod(dims)
    return max(1, chips // max(1, chips_per_host))


@dataclass
class SliceTypeConfig:
    """One acquirable slice flavor (the ``slices:`` section of the
    cluster YAML — see ``autoscaler/launcher.py``)."""
    name: str
    topology: str = "2x2"
    host_resources: Dict[str, float] = field(
        default_factory=lambda: {"CPU": 1})
    min_slices: int = 0
    max_slices: int = 4

    @property
    def num_hosts(self) -> int:
        return hosts_for_topology(self.topology)


@dataclass(frozen=True)
class DrainNotice:
    """One drain notice, delivered to ``on_drain`` callbacks exactly
    once per slice drain (the DRAINING state guard makes a second
    notice for the same drain a no-op). ``deadline_s`` is the
    manager's ``drain_deadline_s`` — the longest a consumer can count
    on the slice's hosts staying up before the forced release."""
    slice_id: str
    reason: str
    hosts: int
    type: str
    deadline_s: float
    ts: float = field(default_factory=time.monotonic)


@dataclass
class SliceInfo:
    """Tracked lifecycle of one acquired slice."""
    slice_id: str
    type: str
    num_hosts: int
    state: str = REQUESTED
    created_at: float = field(default_factory=time.monotonic)
    hosts_joined: int = 0  # host VMs registered AND alive
    up_at: Optional[float] = None
    draining_since: Optional[float] = None
    drain_reason: str = ""
    released_at: Optional[float] = None


def _demand_feasible(t: SliceTypeConfig, demand: dict) -> bool:
    """Can ONE slice of this type ever host the gang? (host count and
    per-bundle shape only — the bundle planner does live capacity)."""
    if t.num_hosts < int(demand.get("hosts", 1)):
        return False
    for b in demand.get("bundles", ()):
        if any(t.host_resources.get(k, 0.0) < v for k, v in b.items()):
            return False
    return True


def plan_slice_scaling(slice_demand: List[dict],
                       slices: Iterable[SliceInfo],
                       slice_types: Dict[str, SliceTypeConfig],
                       idle_slice_ids: Iterable[str] = ()
                       ) -> Dict[str, Any]:
    """Pure decision function: (pending slice-spanning gangs, tracked
    slices) -> ``{"acquire": {type: n}, "release": [slice_id]}``.

    Each demand entry is ``{"hosts": h, "bundles": [res, ...]}``
    (``collect_demand_snapshot``'s ``slice_demand``). Matching is
    deliberately conservative: each live (REQUESTED/UP, non-draining)
    slice absorbs one pending gang — two gangs that could co-reside
    may transiently over-provision, and the idle scale-down reclaims
    the extra slice. Idle slices release only above the type's
    ``min_slices`` floor and only when no gang is pending."""
    live = [s for s in slices if s.state in (REQUESTED, UP)]
    free = {s.slice_id: s for s in live}
    counts: Dict[str, int] = {}
    for s in live:
        counts[s.type] = counts.get(s.type, 0) + 1

    acquire: Dict[str, int] = {}
    for d in slice_demand:
        # an existing slice big enough absorbs the gang (the bundle
        # planner will fit it for real)
        taken = None
        for sid, s in sorted(free.items()):
            t = slice_types.get(s.type)
            if t is not None and _demand_feasible(t, d) \
                    and s.num_hosts >= int(d.get("hosts", 1)):
                taken = sid
                break
        if taken is not None:
            del free[taken]
            continue
        for name in sorted(slice_types):
            t = slice_types[name]
            total = counts.get(name, 0) + acquire.get(name, 0)
            if total >= t.max_slices:
                continue
            if _demand_feasible(t, d):
                acquire[name] = acquire.get(name, 0) + 1
                break
        # infeasible demand stays pending (the scheduler keeps the
        # group queued; nothing to launch)

    # min_slices floor
    for name, t in slice_types.items():
        total = counts.get(name, 0) + acquire.get(name, 0)
        if total < t.min_slices:
            acquire[name] = acquire.get(name, 0) + \
                (t.min_slices - total)

    release: List[str] = []
    if not slice_demand:
        by_type: Dict[str, List[SliceInfo]] = {}
        for s in live:
            if s.state == UP:
                by_type.setdefault(s.type, []).append(s)
        idle = set(idle_slice_ids)
        for name, insts in by_type.items():
            t = slice_types.get(name)
            floor = t.min_slices if t else 0
            killable = [s for s in insts if s.slice_id in idle]
            for s in killable[:max(0, len(insts) - floor)]:
                release.append(s.slice_id)
    return {"acquire": acquire, "release": release}


class SliceManager:
    """Controller-side owner of the slice lifecycle (see module
    docstring). Drives any :class:`NodeProvider` with the slice API;
    composes with :class:`~ray_tpu_torch.autoscaler.v2.AutoscalerV2`
    (``slice_manager=``) or runs standalone via :meth:`update` under
    an ``AutoscalerMonitor``."""

    def __init__(self, controller, provider: NodeProvider,
                 slice_types: List[SliceTypeConfig],
                 idle_timeout_s: float = 60.0,
                 drain_deadline_s: float = 30.0,
                 recorder=None):
        self.controller = controller
        self.provider = provider
        self.slice_types = {t.name: t for t in slice_types}
        self.idle_timeout_s = idle_timeout_s
        self.drain_deadline_s = drain_deadline_s
        self.slices: Dict[str, SliceInfo] = {}
        self._idle_since: Dict[str, float] = {}
        self._drain_callbacks: List[Any] = []
        self._recorder = recorder if recorder is not None \
            else getattr(controller, "recorder", None)
        self.adopt_existing()

    # ----------------------------------------------------- drain hook
    def register_on_drain(self, callback) -> Any:
        """Register ``callback(notice: DrainNotice)`` to run when a
        slice flips to DRAINING — fired exactly once per notice (the
        DRAINING/RELEASED guard in :meth:`drain_slice` dedupes), AFTER
        the slice's placement groups were re-queued and BEFORE the
        release, so an elastic trainer can snapshot from the still-live
        hosts.

        The hook is MULTI-SUBSCRIBER: every registered callback
        observes every notice (an arbiter and an ``ElasticTrainer``
        both see the same drain without stealing it from each other).
        Dispatch order is registration order (FIFO), and a callback
        unregistered while a dispatch is in flight — including by an
        earlier callback of the SAME dispatch — is skipped rather than
        fired against a subscriber that believes it already detached.
        Callbacks run synchronously on the draining thread; exceptions
        are logged and swallowed, and a callback that never consumes
        its notice cannot block the ``drain_deadline_s`` release path —
        release is driven by :meth:`_finish_drains`, not by callback
        completion. Returns the callback (decorator friendly)."""
        self._drain_callbacks.append(callback)
        return callback

    def unregister_on_drain(self, callback) -> None:
        try:
            self._drain_callbacks.remove(callback)
        except ValueError:
            pass

    def _dispatch_drain_notice(self, notice: "DrainNotice") -> int:
        """Fan one notice out to every live subscriber in registration
        order. The snapshot fixes the order; the membership check at
        call time honors unregister-during-dispatch (a subscriber
        removed by an earlier callback in this same dispatch must not
        fire). Returns the number of callbacks actually invoked."""
        fired = 0
        for cb in list(self._drain_callbacks):
            if cb not in self._drain_callbacks:
                continue
            fired += 1
            try:
                cb(notice)
            except Exception:
                logger.exception("on_drain callback failed for %s",
                                 notice.slice_id)
        return fired

    def adopt_existing(self) -> None:
        """Adopt slices the provider already tracks but this manager
        didn't acquire — e.g. the ``count:`` slices ``ray-tpu up``
        created before the head-started monitor came up. Without
        adoption the manager would double-acquire for the first gang
        an existing slice could host. Adopted slices start REQUESTED
        and flip UP through the normal :meth:`_sync` join path. Called
        at construction and on every :meth:`update` pass (cheap), so
        slices created by a concurrent launcher are picked up too."""
        reload_state = getattr(self.provider, "reload_state", None)
        if reload_state is not None:
            try:
                reload_state()
            except Exception:
                logger.exception("provider reload_state failed")
        try:
            existing = self.provider.non_terminated_nodes()
        except Exception:
            return
        for sid in existing:
            if sid in self.slices:
                continue
            try:
                tname = self.provider.node_type(sid)
            except Exception:
                continue
            t = self.slice_types.get(tname)
            if t is None:
                continue
            self.slices[sid] = SliceInfo(
                slice_id=sid, type=tname, num_hosts=t.num_hosts)
            logger.info("slices: adopted existing %s (%s, %d hosts)",
                        sid, tname, t.num_hosts)

    # -------------------------------------------------------- plumbing
    def _record(self, ev: str, **data) -> None:
        r = self._recorder
        if r is None:
            return
        try:
            r.record(ev, **data)
        except Exception:
            pass

    def _call_on_loop(self, fn):
        call = getattr(self.controller, "call_on_loop", None)
        return call(fn) if call is not None else fn()

    def _update_gauges(self) -> None:
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            m = runtime_metrics()
            m.slices_up.set(sum(
                1 for s in self.slices.values() if s.state == UP))
            m.slice_hosts_pending.set(sum(
                max(0, s.num_hosts - s.hosts_joined)
                for s in self.slices.values()
                if s.state == REQUESTED))
        except Exception:
            pass

    # ---------------------------------------------------------- acquire
    def acquire_slice(self, type_name: str) -> Optional[str]:
        """Request one whole slice of the named type; returns its id,
        or None when the provider is out of capacity (demand stays
        pending and a later pass retries)."""
        t = self.slice_types[type_name]
        try:
            sid = self.provider.create_slice(
                t.name, t.topology, dict(t.host_resources))
        except SliceCapacityError as e:
            logger.warning("slice acquire deferred (%s): %s",
                           type_name, e)
            return None
        self.slices[sid] = SliceInfo(
            slice_id=sid, type=type_name, num_hosts=t.num_hosts)
        logger.info("slices: requested %s (%s, %d hosts)", sid,
                    t.topology, t.num_hosts)
        return sid

    def wait_until_up(self, slice_id: str,
                      timeout_s: float = 60.0) -> bool:
        """Block (polling) until every host VM of the slice registered
        — test/launcher convenience; the reconcile loop never blocks
        here."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            snap = self._snapshot()
            self._sync(snap)
            info = self.slices.get(slice_id)
            if info is not None and info.state == UP:
                return True
            if info is None or info.state in (DRAINING, RELEASED):
                return False
            time.sleep(0.2)
        return False

    # ------------------------------------------------------------ drain
    def drain_slice(self, slice_id: str, reason: str) -> None:
        """Maintenance notice handling: stop new leases on every host,
        tear down + re-queue the slice's placement groups, and start
        the drain clock. The slice releases when its hosts go quiet or
        at ``drain_deadline_s`` — whichever comes first, so a wedged
        workload cannot hang the release."""
        info = self.slices.get(slice_id)
        if info is None or info.state in (DRAINING, RELEASED):
            return
        info.state = DRAINING
        info.draining_since = time.monotonic()
        info.drain_reason = reason
        self._record("SLICE_DRAIN", slice=slice_id, reason=reason,
                     hosts=info.num_hosts, type=info.type)
        logger.warning("slices: draining %s (%s)", slice_id, reason)
        host_bs = self.provider.internal_ids(slice_id)

        def _on_loop():
            from ray_tpu_torch.core.ids import NodeID
            sched = getattr(self.controller, "scheduler", None)
            if sched is not None:
                for nb in host_bs:
                    sched.set_draining(NodeID(nb), True)
            resched = getattr(self.controller,
                              "_reschedule_pgs_on_nodes", None)
            moved = resched(set(host_bs)) if resched else 0
            kick = getattr(self.controller, "_maybe_schedule", None)
            if moved and kick is not None:
                kick()
            return moved

        try:
            moved = self._call_on_loop(_on_loop)
            if moved:
                logger.info("slices: re-queued %d placement group(s) "
                            "off %s", moved, slice_id)
        except Exception:
            logger.exception("slice drain hook failed for %s", slice_id)
        notice = DrainNotice(
            slice_id=slice_id, reason=reason, hosts=info.num_hosts,
            type=info.type, deadline_s=self.drain_deadline_s)
        self._dispatch_drain_notice(notice)
        self._update_gauges()

    def _release(self, slice_id: str) -> None:
        info = self.slices.get(slice_id)
        if info is None or info.state == RELEASED:
            return
        host_bs = self.provider.internal_ids(slice_id)
        try:
            self.provider.delete_slice(slice_id)
        except Exception:
            logger.exception("delete_slice failed for %s", slice_id)
        now = time.monotonic()
        drain_s = now - (info.draining_since or now)
        info.state = RELEASED
        info.released_at = now
        self._idle_since.pop(slice_id, None)

        # proactive death notice: the hosts are gone NOW — declaring
        # them dead immediately (instead of waiting out the heartbeat
        # threshold) lets stranded actors restart onto the group's
        # fresh reservation right away
        def _notify():
            nodes = getattr(self.controller, "nodes", None)
            dead = getattr(self.controller, "_on_node_dead", None)
            if nodes is None or dead is None:
                return
            for nb in host_bs:
                node = nodes.get(nb)
                if node is not None and node.alive:
                    dead(node)

        try:
            self._call_on_loop(_notify)
        except Exception:
            pass
        self._record("SLICE_DOWN", slice=slice_id,
                     reason=info.drain_reason or "released",
                     dur_s=round(drain_s, 6), hosts=info.num_hosts)
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            runtime_metrics().slice_drain_seconds.observe(drain_s)
        except Exception:
            pass
        logger.info("slices: released %s after %.2fs drain (%s)",
                    slice_id, drain_s, info.drain_reason or "idle")
        self._update_gauges()

    # -------------------------------------------------------- reconcile
    def _snapshot(self) -> dict:
        from ray_tpu_torch.autoscaler.autoscaler import collect_demand_snapshot
        return self._call_on_loop(
            lambda: collect_demand_snapshot(self.controller))

    def _sync(self, snap: dict) -> None:
        """Observed state -> lifecycle transitions."""
        alive = snap.get("alive_nodes", set())
        for sid, info in list(self.slices.items()):
            if info.state == REQUESTED:
                ids = self.provider.internal_ids(sid)
                info.hosts_joined = sum(1 for i in ids if i in alive)
                if len(ids) >= info.num_hosts and \
                        all(i in alive for i in ids):
                    info.state = UP
                    info.up_at = time.monotonic()
                    self._record("SLICE_UP", slice=sid,
                                 hosts=info.num_hosts, type=info.type)
                    logger.info("slices: %s UP (%d hosts joined)",
                                sid, info.num_hosts)
            elif info.state == UP:
                ids = self.provider.internal_ids(sid)
                if ids and any(i not in alive for i in ids):
                    # a host died without notice (hard preemption):
                    # the slice is broken as a unit — drain + release
                    self.drain_slice(sid, "host-death")

    def poll_maintenance(self) -> List[dict]:
        """Consume the provider's drain notices (each reported once)."""
        try:
            events = self.provider.maintenance_events()
        except Exception:
            logger.exception("maintenance_events failed")
            return []
        for ev in events:
            sid = ev.get("slice_id")
            if sid in self.slices and \
                    self.slices[sid].state in (REQUESTED, UP):
                self.drain_slice(sid, ev.get("kind", "maintenance"))
        return events

    def _finish_drains(self, snap: dict) -> List[str]:
        busy_nodes = snap.get("busy_nodes", set())
        released = []
        now = time.monotonic()
        for sid, info in list(self.slices.items()):
            if info.state != DRAINING:
                continue
            ids = self.provider.internal_ids(sid)
            busy = any(i in busy_nodes for i in ids)
            deadline_hit = info.draining_since is not None and \
                now - info.draining_since >= self.drain_deadline_s
            if not busy or deadline_hit:
                self._release(sid)
                released.append(sid)
        return released

    def update(self, snap: Optional[dict] = None) -> Dict[str, Any]:
        """One reconcile pass: sync joins, consume maintenance, finish
        drains, then scale slice inventory to pending gang demand (up)
        and idleness (down, whole slices only)."""
        if snap is None:
            snap = self._snapshot()
        self.adopt_existing()
        self._sync(snap)
        self.poll_maintenance()
        released = self._finish_drains(snap)

        # idle tracking: a slice is idle only when EVERY host is quiet
        now = time.monotonic()
        slice_demand = snap.get("slice_demand", [])
        busy_nodes = snap.get("busy_nodes", set())
        idle = []
        for sid, info in self.slices.items():
            if info.state != UP or slice_demand:
                self._idle_since.pop(sid, None)
                continue
            ids = self.provider.internal_ids(sid)
            if any(i in busy_nodes for i in ids):
                self._idle_since.pop(sid, None)
                continue
            since = self._idle_since.setdefault(sid, now)
            if now - since >= self.idle_timeout_s:
                idle.append(sid)

        plan = plan_slice_scaling(
            slice_demand, self.slices.values(), self.slice_types, idle)
        acquired: List[str] = []
        for name, n in plan["acquire"].items():
            for _ in range(n):
                sid = self.acquire_slice(name)
                if sid:
                    acquired.append(sid)
        for sid in plan["release"]:
            ids = self.provider.internal_ids(sid)

            def _gang_drain(ids=ids):
                from ray_tpu_torch.autoscaler.autoscaler import \
                    drain_nodes_if_idle
                return drain_nodes_if_idle(self.controller, list(ids))

            # atomic gang drain: one host getting busy between the
            # idle check and this call vetoes the whole slice
            try:
                ok = self._call_on_loop(_gang_drain) if ids else True
            except Exception:
                ok = False
            if not ok:
                self._idle_since.pop(sid, None)
                continue
            self.drain_slice(sid, "idle")
            self._release(sid)
            released.append(sid)
        self._update_gauges()
        return {"acquired": acquired, "released": released,
                "slices": {sid: s.state
                           for sid, s in self.slices.items()}}

    # ------------------------------------------------------------ views
    def stats(self) -> Dict[str, Any]:
        return {
            "slices_up": sum(1 for s in self.slices.values()
                             if s.state == UP),
            "slices_draining": sum(1 for s in self.slices.values()
                                   if s.state == DRAINING),
            "slices": {sid: {"state": s.state, "type": s.type,
                             "hosts": s.num_hosts}
                       for sid, s in self.slices.items()},
        }

    def shutdown(self) -> None:
        """Release every live slice (test teardown)."""
        for sid, info in list(self.slices.items()):
            if info.state in (REQUESTED, UP, DRAINING):
                self._release(sid)
