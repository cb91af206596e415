"""The controller: single control-plane authority for the cluster.

Equivalent of the reference's GCS server (``src/ray/gcs/gcs_server/
gcs_server.cc:138``) *plus* the scheduling half of the raylet
(``ClusterTaskManager`` / ``LocalTaskManager``): node membership, actor
directory, placement groups, KV store, function store, pubsub, health
checks, task-event sink, object directory, reference-count authority, and
task scheduling/dispatch. Collapsing GCS + raylet scheduling into one
authority removes the gossip/spillback machinery (``ray_syncer``,
``HandleRequestWorkerLease``) — consistent-by-construction scheduling, at
the cost of a single broker hop per message, which a TPU-pod-scale cluster
(tens of hosts, not thousands) tolerates.

Threading model: one event-loop thread owns the ROUTER socket (mirroring the
GCS's single asio io_context); cross-thread sends are marshaled through a
queue + wakeup. A background thread runs health checks.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import zmq

from ray_tpu_torch.core import chaos as CH
from ray_tpu_torch.core import events as EV
from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core import reliable as RD
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from ray_tpu_torch.core.reference_counter import GlobalRefTable
from ray_tpu_torch.core.scheduler import ClusterResourceScheduler, NodeResources
from ray_tpu_torch.core.task_spec import ActorInfo, PlacementGroupSpec, TaskSpec

logger = logging.getLogger(__name__)


@dataclass
class ObjectEntry:
    object_id: ObjectID
    #: two owners: ``owner`` is the process a fetch asks for the value
    #: (for a task's result, the process that reported it); ``owned_by``
    #: is the process whose refs own the object (the putter, or the
    #: caller of the task that made it), whose death frees the object if
    #: no live process counts it. They differ only for a task's result;
    #: ``owned_by`` is set through ``Controller._set_owned_by``, which
    #: keeps its index.
    owner: Optional[bytes] = None
    owned_by: Optional[bytes] = None
    inline: Optional[bytes] = None         # small-object payload
    size: int = 0
    locations: Set[bytes] = field(default_factory=set)   # node_id binaries
    error: Optional[bytes] = None          # pickled exception
    lineage_task: Optional[TaskSpec] = None
    spillable: bool = True


@dataclass
class PendingTask:
    spec: TaskSpec
    state: str = "PENDING_DEPS"  # PENDING_DEPS | QUEUED | PENDING_TRANSFER | RUNNING
    node_id: Optional[NodeID] = None
    worker: Optional[bytes] = None
    retries_left: int = 0
    submitted_at: float = 0.0
    deps_remaining: Set[bytes] = field(default_factory=set)
    transfers_remaining: Set[bytes] = field(default_factory=set)
    #: Scheduling-class key (reference: SchedulingClass in task_spec.h —
    #: tasks with identical resource shapes share feasibility): tasks whose
    #: key failed to place in a drain are skipped wholesale, making the
    #: drain O(#shapes + #dispatched) instead of O(#queued).
    shape_key: Optional[tuple] = None
    #: OOM kills draw from their own budget (reference: task_oom_retries),
    #: not max_retries; -1 = uninitialized (filled from config on first use)
    oom_retries_left: int = -1


@dataclass
class Lease:
    """A worker leased to one scheduling class (reference: worker leases,
    ``direct_task_transport.h`` — ``OnWorkerIdle`` pipelines queued tasks of
    the same scheduling key onto an already-leased worker). The lease holds
    exactly one resource allocation; up to ``dispatch_pipeline_depth`` tasks
    ride it concurrently (executed serially worker-side)."""
    worker: bytes
    node_b: bytes
    shape_key: tuple
    resources: Dict[str, float]
    inflight: Set[bytes] = field(default_factory=set)
    #: worker is blocked in a ray.get inside a task: its cpu is released
    #: and the pipeline is not refilled until it unblocks
    blocked: bool = False


@dataclass
class NodeInfo:
    node_id: NodeID
    identity: bytes
    resources: NodeResources
    last_heartbeat: float = 0.0
    idle_workers: Deque[bytes] = field(default_factory=collections.deque)
    all_workers: Dict[bytes, dict] = field(default_factory=dict)  # identity -> info
    starting_workers: int = 0
    stats: dict = field(default_factory=dict)
    alive: bool = True


class Controller:
    def __init__(self, session_dir: str, config: Config):
        self.session_dir = session_dir
        self.config = config
        # seeded fault injection (chaos.py): None in production
        self._chaos = CH.maybe_injector("controller")
        self._chaos_dedup = CH.SeqDeduper() if self._chaos is not None \
            else None
        # flight recorder + aggregation sink (core/events.py): the
        # controller's own events ingest locally; every other process
        # flushes TASK_EVENTS batches here. Guarded by _events_lock —
        # ingest can fire from the reliable layer's retransmit thread.
        self._events_lock = threading.Lock()
        self.flight_events: List[dict] = []
        self.recorder = EV.make_recorder("controller", config,
                                         send=self._ingest_events)
        # fleet metrics plane (core/metrics_plane.py): every process's
        # METRIC_REPORT snapshots merge here into bounded time-series
        # rings; the controller's own registry self-ingests through the
        # same path (MetricsPlane is internally locked — ingest fires
        # from the loop thread AND the health thread, the dashboard's
        # HTTP threads query).
        from ray_tpu_torch.core.metrics_plane import MetricsPlane
        from ray_tpu_torch.util import metrics as MX
        self.metrics_plane = MetricsPlane.from_config(config)
        # per-request trace store (serve/request_trace.py): replicas /
        # routers ship tail-sampled REQUEST_SPANS batches here.
        # Internally locked like the metrics plane — the dashboard's
        # HTTP threads read it directly.
        from ray_tpu_torch.serve.request_trace import RequestTraceStore
        self.request_traces = RequestTraceStore(
            max_requests=getattr(config, "request_trace_max", 512))
        self.metrics_reporter = MX.make_reporter(
            self.metrics_plane.ingest,
            {"node": "head", "pid": os.getpid(), "role": "controller"},
            config)
        # reliable-delivery sublayer: TASK_DISPATCH/TASK_ASSIGN/
        # TASK_RESULT to workers, nodes and owners get ack/retransmit;
        # resends re-enter _send (thread-safe cross-thread marshal)
        self._reliable = RD.maybe_transport(
            config, lambda t, mt, pl: self._send(t, mt, pl),
            lambda route, pl: self._send(route, P.MSG_ACK, pl),
            rng=self._chaos.rng_for("retransmit")
            if self._chaos is not None else None, name="controller",
            recorder=self.recorder)
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.ROUTER)
        self.sock.setsockopt(zmq.ROUTER_MANDATORY, 0)
        self.sock.setsockopt(zmq.LINGER, 0)
        # unbounded per-peer queues: result bursts (thousands of TASK_RESULT
        # pushes to one owner) must not be silently dropped at the HWM
        self.sock.setsockopt(zmq.SNDHWM, 0)
        self.sock.setsockopt(zmq.RCVHWM, 0)
        self.addr = P.socket_path(session_dir)
        self.sock.bind(self.addr)
        # wakeup channel for cross-thread sends
        self._wake_recv = self.ctx.socket(zmq.PULL)
        self._wake_recv.bind(f"inproc://ctl-wake-{id(self)}")
        self._wake_send = self.ctx.socket(zmq.PUSH)
        self._wake_send.connect(f"inproc://ctl-wake-{id(self)}")
        # the wake socket is written from every thread that marshals work
        # onto the loop (health loop, retransmits, API callers) and closed
        # by the loop at exit: a zmq socket is not thread-safe, so every
        # send and the close hold this lock (a port-only repair: a close
        # racing a health-loop send crashed the process in zmq)
        self._wake_lock = threading.Lock()
        self._wake_closed = False
        self._send_q: Deque[Tuple[bytes, bytes, bytes]] = collections.deque()
        self._call_q: Deque = collections.deque()  # marshaled loop calls
        self._send_lock = threading.Lock()
        self._sched_dirty = True
        # local_waiters parked on UNKNOWN objects: first-park timestamp
        # + audit strike counts (directory-hole detection)
        self._waiter_since: Dict[bytes, float] = {}
        self._hole_strikes: Dict[bytes, int] = {}
        # owner-local objects a borrower is parked on: object_id ->
        # owner identity we asked to publish (FETCH_OBJECT). Resolved by
        # the owner's PUT_OBJECT; audited against owner death.
        self._owner_fetches: Dict[bytes, bytes] = {}
        # rid -> (Event, slot) for in-flight worker profile requests
        # (dashboard HTTP threads wait; _h_profile_result fulfills)
        self._profile_waiters: Dict[bytes, tuple] = {}
        # last spawn-ahead pass for queued actor creations (rate limit)
        self._last_actor_prestart = 0.0
        # worker -> last runtime-env key (env-affinity dispatch)
        self._worker_env: Dict[bytes, str] = {}
        # workers that have run a task or an actor asking for GPU: each
        # holds a CUDA context, so it stays out of default-shape driver
        # leases and is preferred for the next GPU task (a port-only
        # divergence from the JAX runtime)
        self._gpu_workers: Set[bytes] = set()
        # worker identity -> owning driver identity: workers leased to a
        # driver for DIRECT task submission (reference: worker leases,
        # direct_task_transport.h — tasks bypass the controller wholly;
        # TASK_DONE only records results)
        self.driver_leases: Dict[bytes, bytes] = {}
        self._lease_node: Dict[bytes, bytes] = {}  # leased worker -> node
        self._pending_leases: List[tuple] = []  # [(driver, count_still_wanted)]
        self._lease_blocked: set = set()  # driver-leased workers in ray.get
        # reclaimed-while-blocked workers parked until NOTIFY_UNBLOCKED
        self._blocked_orphans: set = set()
        # per-peer outbox for loop-thread sends: flushed once per event-loop
        # cycle as MSG_BATCH frames — amortizes pickling + syscalls over a
        # burst without adding latency (flush happens before the next poll)
        self._outbox: Dict[bytes, List[Tuple[bytes, Any]]] = {}

        self.scheduler = ClusterResourceScheduler()
        self.refs = GlobalRefTable(self._queue_refcount_zero)
        #: delta-driven zero events park here for a grace window before
        #: the actual free: cross-process delta batches can zero the
        #: aggregate transiently while a direct-path consumer's pin
        #: (+1) is still in flight — freeing immediately loses the only
        #: copy of an object a queued task still needs. Owner-initiated
        #: frees (_h_owner_free) stay immediate: the owner's count is
        #: authoritative (reference: frees are owner-driven,
        #: reference_count.h).
        self._pending_frees: Dict[bytes, float] = {}

        self.peers: Dict[bytes, dict] = {}          # identity -> {kind, node_id}
        self.nodes: Dict[bytes, NodeInfo] = {}      # node_id binary -> NodeInfo
        self.objects: Dict[bytes, ObjectEntry] = {}
        #: the objects of ``objects`` by ``owned_by``, so that a process's
        #: death releases its own without a walk of the table
        self._owned: Dict[bytes, Set[bytes]] = {}
        self.actors: Dict[bytes, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], bytes] = {}
        # callers long-polling for an actor's worker address (direct calls)
        self.actor_addr_waiters: Dict[bytes, List[Tuple[bytes, bytes]]] = \
            collections.defaultdict(list)
        self.actor_queues: Dict[bytes, Deque[Tuple[bytes, TaskSpec]]] = {}
        self.actor_workers: Dict[bytes, bytes] = {}   # actor_id -> worker identity
        self.worker_actors: Dict[bytes, bytes] = {}   # worker identity -> actor_id
        self.kv: Dict[str, Dict[bytes, bytes]] = collections.defaultdict(dict)
        self.functions: Dict[str, bytes] = {}
        self.pgs: Dict[bytes, PlacementGroupSpec] = {}
        self.pg_states: Dict[bytes, str] = {}
        self.pg_creators: Dict[bytes, bytes] = {}  # pg_id -> creator identity
        self.pending_pgs: Deque[Tuple[bytes, PlacementGroupSpec]] = collections.deque()
        self.subs: Dict[str, Set[bytes]] = collections.defaultdict(set)

        self.tasks: Dict[bytes, PendingTask] = {}    # task_id -> PendingTask
        # ready tasks grouped by scheduling class; dict preserves insertion
        # order so classes are drained round-robin-by-arrival
        self.ready_queues: Dict[tuple, Deque[bytes]] = {}
        self.leases: Dict[bytes, Lease] = {}          # worker identity -> lease
        self.class_leases: Dict[tuple, Set[bytes]] = collections.defaultdict(set)
        self.dep_waiters: Dict[bytes, Set[bytes]] = collections.defaultdict(set)   # object -> task_ids
        self.local_waiters: Dict[bytes, List[Tuple[bytes, bytes]]] = collections.defaultdict(list)  # object -> [(identity, rid)]
        self.task_table: Dict[bytes, dict] = {}       # state-API rows
        self.task_events: List[dict] = []
        self.jobs: Dict[bytes, dict] = {}
        self._job_counter = 0

        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._transfers: Dict[Tuple[bytes, bytes], int] = {}  # (object, dest_node) -> attempt

        # durable state (reference: gcs store client + redis tables);
        # everything not recovered here is re-announced via RECONNECT
        from ray_tpu_torch.core.persistence import ControllerStore
        self.store = ControllerStore(session_dir)
        #: incarnation id: peers re-announce AT MOST ONCE per controller
        #: generation (a second RECONNECT for the same generation must not
        #: double-apply absolute refcounts or resubmit tasks twice)
        self.generation = os.urandom(8)
        self._reconnect_sent: Dict[bytes, float] = {}
        #: worker re-registrations that raced ahead of their node's
        #: re-registration; replayed when the node arrives
        self._orphan_workers: Dict[bytes, List[Tuple[bytes, dict]]] = \
            collections.defaultdict(list)
        self._started_at = time.monotonic()
        self._recovered_actors: Set[bytes] = set()
        self._recover()

    # ------------------------------------------------- durable state
    def _durable_state(self) -> dict:
        return {
            "kv": {ns: dict(d) for ns, d in self.kv.items()},
            "functions": dict(self.functions),
            "named_actors": [
                (info.namespace, info.name, info.spec)
                for aid, info in self.actors.items()
                if info.name and info.state != "DEAD"],
            "job_counter": self._job_counter,
        }

    def _recover(self) -> None:
        snap, ops = self.store.load()
        state = snap or {"kv": {}, "functions": {},
                         "named_actors": [], "job_counter": 0}
        for ns, d in state["kv"].items():
            self.kv[ns].update(d)
        self.functions.update(state["functions"])
        self._job_counter = state["job_counter"]
        named = {(ns, name): spec
                 for ns, name, spec in state["named_actors"]}
        for op in ops:
            kind = op[0]
            if kind == "kv_put":
                self.kv[op[1]][op[2]] = op[3]
            elif kind == "kv_del":
                self.kv[op[1]].pop(op[2], None)
            elif kind == "fn":
                self.functions[op[1]] = op[2]
            elif kind == "actor":
                spec = op[1]
                named[(spec.namespace, spec.actor_name)] = spec
            elif kind == "actor_dead":
                named = {k: s for k, s in named.items()
                         if s.actor_id.binary() != op[1]}
            elif kind == "job_counter":
                self._job_counter = max(self._job_counter, op[1])
        for (ns, name), spec in named.items():
            aid = spec.actor_id.binary()
            # RESTARTING until the hosting worker re-announces itself
            # (or the health loop's grace window expires it)
            self.actors[aid] = ActorInfo(
                actor_id=spec.actor_id, spec=spec, state="RESTARTING",
                name=name, namespace=ns)
            self.named_actors[(ns, name)] = aid
            self.actor_queues.setdefault(aid, collections.deque())
            self._recovered_actors.add(aid)
        if snap is not None or ops:
            logger.info(
                "controller: recovered %d kv namespaces, %d functions, "
                "%d named actors", len(self.kv), len(self.functions),
                len(named))

    # ------------------------------------------------------------------ run
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="controller", daemon=True)
        self._thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="controller-health", daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._shutdown.set()
        if self._reliable is not None:
            self._reliable.stop()
        with self._send_lock:
            pass
        self.wake()
        if self._thread:
            self._thread.join(timeout=5)
        if self._health_thread:
            self._health_thread.join(timeout=5)
        self.store.close()

    def wake(self) -> None:
        """Wake the loop thread (from any thread); a no-op once the loop
        has closed its wake socket."""
        with self._wake_lock:
            if self._wake_closed:
                return
            try:
                self._wake_send.send(b"", zmq.NOBLOCK)
            except zmq.ZMQError:
                pass

    def _run(self) -> None:
        poller = zmq.Poller()
        poller.register(self.sock, zmq.POLLIN)
        poller.register(self._wake_recv, zmq.POLLIN)
        while not self._shutdown.is_set():
            try:
                events = dict(poller.poll(timeout=1000))
            except zmq.ZMQError:
                break
            if self._wake_recv in events:
                while True:
                    try:
                        self._wake_recv.recv(zmq.NOBLOCK)
                    except zmq.ZMQError:
                        break
            self._drain_sends()
            self._drain_calls()
            if self.sock in events:
                for _ in range(1000):
                    try:
                        frames = self.sock.recv_multipart(zmq.NOBLOCK)
                    except zmq.ZMQError:
                        break
                    try:
                        self._handle(frames)
                    except Exception:
                        logger.exception("controller: error handling %s",
                                         frames[1] if len(frames) > 1 else frames)
            self._flush_outbox()
            self._drain_sends()
            # latency bound on the controller's OWN flight-recorder
            # events reaching the aggregation buffer
            self.recorder.maybe_flush()
        with self._wake_lock:
            self._wake_closed = True
            self._wake_send.close(0)
        try:
            self.sock.close(0)
            self._wake_recv.close(0)
        except Exception:
            pass

    def call_on_loop(self, fn, timeout: float = 10.0):
        """Run ``fn()`` on the controller loop thread and return its
        result. All controller state is owned by that single thread
        (mirroring the GCS's one io_context) — cross-thread readers like
        the dashboard must marshal through here rather than iterate live
        dicts."""
        if threading.current_thread() is self._thread:
            return fn()
        done = threading.Event()
        box: list = [None, None]

        def run():
            try:
                box[0] = fn()
            except BaseException as e:  # noqa: BLE001
                box[1] = e
            done.set()

        with self._send_lock:
            self._call_q.append(run)
        self.wake()
        deadline = time.monotonic() + timeout
        while not done.wait(0.05):
            if time.monotonic() > deadline or (
                    self._shutdown.is_set() and not self._thread.is_alive()):
                raise TimeoutError("controller loop busy")
        if box[1] is not None:
            raise box[1]
        return box[0]

    def _drain_calls(self) -> None:
        while self._call_q:
            try:
                run = self._call_q.popleft()
            except IndexError:
                break
            try:
                run()
            except Exception:
                logger.exception("controller: error in marshaled call")

    def _send(self, identity: bytes, mtype: bytes, payload: Any) -> None:
        """Thread-safe send. Loop-thread sends are buffered per peer and
        flushed at the end of the handling cycle (order-preserving);
        cross-thread sends are marshaled through the wake channel."""
        if self._reliable is not None:
            # stamp + ring-record critical one-way messages before the
            # chaos filter (a dropped message must already be tracked);
            # retransmitted payloads pass through untouched
            payload = self._reliable.stamp(identity, mtype, payload)
        if self._chaos is not None:
            for delay_s, pl in self._chaos.plan_send(
                    identity, mtype, payload):
                if delay_s > 0.0:
                    # the timer thread re-enters via the cross-thread
                    # marshal path, which is safe from any thread
                    t = threading.Timer(delay_s, self._send_now,
                                        args=(identity, mtype, pl))
                    t.daemon = True
                    t.start()
                else:
                    self._send_now(identity, mtype, pl)
            return
        self._send_now(identity, mtype, payload)

    def _send_now(self, identity: bytes, mtype: bytes, payload: Any) -> None:
        if threading.current_thread() is self._thread:
            box = self._outbox.get(identity)
            if box is None:
                box = self._outbox[identity] = []
            box.append((mtype, payload))
        else:
            blob = P.dumps(payload)
            with self._send_lock:
                self._send_q.append((identity, mtype, blob))
            self.wake()

    def _flush_outbox(self) -> None:
        if not self._outbox:
            return
        outbox, self._outbox = self._outbox, {}
        for identity, msgs in outbox.items():
            try:
                if len(msgs) == 1:
                    mtype, payload = msgs[0]
                    self.sock.send_multipart(
                        [identity, mtype, P.dumps(payload)], zmq.NOBLOCK)
                else:
                    self.sock.send_multipart(
                        [identity, P.MSG_BATCH, P.dumps({"msgs": msgs})],
                        zmq.NOBLOCK)
            except zmq.ZMQError:
                logger.warning("controller: drop %d msgs to %s", len(msgs),
                               identity.hex()[:8])

    def _drain_sends(self) -> None:
        while True:
            with self._send_lock:
                if not self._send_q:
                    return
                identity, mtype, blob = self._send_q.popleft()
            try:
                self.sock.send_multipart([identity, mtype, blob], zmq.NOBLOCK)
            except zmq.ZMQError:
                pass

    def _reply(self, identity: bytes, rid: bytes, data: Any, ok: bool = True) -> None:
        self._send(identity, P.GENERIC_REPLY if ok else P.ERROR_REPLY,
                   {"rid": rid, "data": data})

    # ------------------------------------------------------------- dispatch
    def _handle(self, frames: List[bytes]) -> None:
        identity, mtype, payload = frames[0], frames[1], P.loads(frames[2])
        if mtype == P.MSG_BATCH:
            for sub_type, sub_payload in payload["msgs"]:
                try:
                    self._dispatch_msg(identity, sub_type, sub_payload)
                except Exception:
                    logger.exception("controller: error in batched %s",
                                     sub_type)
            return
        self._dispatch_msg(identity, mtype, payload)

    def _dispatch_msg(self, identity: bytes, mtype: bytes, payload: Any) -> None:
        if self._chaos_dedup is not None and CH.check_dedup(
                self._chaos_dedup, payload):
            return  # injected duplicate of a message already handled
        if self._reliable is not None and \
                self._reliable.on_receive(identity, payload):
            return  # retransmit duplicate of a handled message
        if identity not in self.peers and mtype != P.REGISTER:
            # a peer from before a controller restart: process its message
            # (handlers tolerate unknown senders) and ask it to re-announce
            # itself (reference: raylet reconnect, node_manager.cc:1114)
            now = time.monotonic()
            if now - self._reconnect_sent.get(identity, 0.0) > 2.0:
                self._reconnect_sent[identity] = now
                self._send(identity, P.RECONNECT, {"gen": self.generation})
        handler = self._HANDLERS.get(mtype)
        if handler is None:
            logger.warning("controller: unknown message %s", mtype)
            return
        handler(self, identity, payload)

    # -------------------------------------------------------- registration
    def _h_register(self, identity: bytes, m: dict) -> None:
        kind = m["kind"]
        self._sched_dirty = True  # new node/worker = new capacity
        self.peers[identity] = {"kind": kind, "node_id": m.get("node_id"),
                                "pid": m.get("pid")}
        if kind == "node":
            node_id = NodeID(m["node_id"])
            existing = self.nodes.get(node_id.binary())
            if existing is not None and existing.identity == identity:
                # re-registration after a controller restart: keep the
                # NodeInfo we may have partially rebuilt
                existing.last_heartbeat = time.monotonic()
                info = existing
            else:
                res = NodeResources(node_id, m["resources"],
                                    m.get("labels") or {})
                info = NodeInfo(node_id=node_id, identity=identity,
                                resources=res,
                                last_heartbeat=time.monotonic())
                self.nodes[node_id.binary()] = info
                self.scheduler.add_node(res)
                self._publish("node", {"event": "added",
                                       "node_id": m["node_id"],
                                       "resources": m["resources"]})
            # reconnect re-announce: objects the node's store still holds
            # repopulate the object directory (reference: raylet reconnect
            # resends its object table, node_manager.cc:1114)
            for b, size in m.get("objects") or []:
                e = self._entry(b)
                e.locations.add(node_id.binary())
                e.size = e.size or size
                # wake anything already parked on this object (resubmitted
                # tasks in dep_waiters, blocked gets in local_waiters)
                self._object_created(b)
            # replay worker registrations that raced ahead of this node's
            for wid, wm in self._orphan_workers.pop(node_id.binary(), []):
                self._h_register(wid, wm)
        elif kind == "worker":
            nid = m["node_id"]
            node = self.nodes.get(nid)
            if node is None:
                # its node's (re-)registration hasn't arrived yet — stash,
                # else the worker is lost from the pool forever
                self._orphan_workers[nid].append((identity, m))
                return
            if not node.alive:
                # a worker of a DEAD node re-announcing in its death
                # throes (a RECONNECT races the node teardown — seen
                # when a drained slice's hosts get the proactive death
                # notice ~1s before their processes exit): admitting it
                # — especially _restore_actor_binding below — would
                # resurrect an actor onto a walking-dead worker whose
                # death nobody will ever report again, and callers
                # would retarget it forever
                return
            if identity not in node.all_workers:
                node.all_workers[identity] = {"pid": m.get("pid"),
                                              "worker_id": m.get("id")}
                node.starting_workers = max(0, node.starting_workers - 1)
                if m.get("actor_id") is None and not m.get("busy"):
                    # mid-task workers return to the idle pool at their
                    # TASK_DONE (transient resource over-admission until
                    # then self-corrects)
                    node.idle_workers.append(identity)
                    self._grant_parked_leases()
                    self._drain_waiting_tasks(node)
            if m.get("actor_id") is not None:
                self._restore_actor_binding(m["actor_id"], identity,
                                            m.get("node_id"))
        elif kind == "driver":
            if m.get("job_id"):
                # reconnecting driver keeps its job identity
                job_id = JobID(m["job_id"])
                self.jobs.setdefault(job_id.binary(), {
                    "job_id": job_id.hex(), "pid": m.get("pid"),
                    "start_time": time.time(), "status": "RUNNING"})
            else:
                self._job_counter += 1
                self.store.append(("job_counter", self._job_counter))
                job_id = JobID.from_int(self._job_counter)
                self.jobs[job_id.binary()] = {
                    "job_id": job_id.hex(), "pid": m.get("pid"),
                    "start_time": time.time(), "status": "RUNNING"}
            self.peers[identity]["job_id"] = job_id.binary()
            self._send(identity, P.REGISTER_REPLY, {
                "job_id": job_id.binary(),
                "head_node_id": next(iter(self.nodes), b""),
                "session_dir": self.session_dir,
                "config": self.config.to_json(),
            })
            self._prestart_workers()
            self._maybe_schedule()
            return
        self._send(identity, P.REGISTER_REPLY, {"ok": True,
                                                "config": self.config.to_json()})
        self._maybe_schedule()

    def _restore_actor_binding(self, aid: bytes, worker: bytes,
                               node_b: Optional[bytes]) -> None:
        """A surviving actor worker re-announced itself after a controller
        restart: rebind the actor to its worker and flip it ALIVE."""
        self.actor_workers[aid] = worker
        self.worker_actors[worker] = aid
        self._recovered_actors.discard(aid)
        info = self.actors.get(aid)
        if info is None or info.state == "ALIVE":
            return
        info.state = "ALIVE"
        if node_b is not None:
            info.node_id = NodeID(node_b)
            info.worker_id = WorkerID(worker) \
                if len(worker) == WorkerID.SIZE else None
            if info.spec is not None and info.spec.hold_resources:
                # the live actor still occupies its resources; the node's
                # fresh registration reset availability, so re-take them
                self.scheduler.force_acquire(
                    NodeID(node_b), self._sched_res(info.spec))
        self._publish(f"actor:{info.actor_id.hex()}",
                      {"state": "ALIVE", "actor_id": aid})
        self._answer_actor_addr_waiters(aid)

    # ------------------------------------------------------------- objects
    def _entry(self, object_id_b: bytes) -> ObjectEntry:
        e = self.objects.get(object_id_b)
        if e is None:
            e = ObjectEntry(ObjectID(object_id_b))
            self.objects[object_id_b] = e
        return e

    def _set_owned_by(self, e: ObjectEntry, who: Optional[bytes]) -> None:
        if e.owned_by == who:
            return
        self._unindex_owned(e)
        e.owned_by = who
        if who is not None:
            self._owned.setdefault(who, set()).add(e.object_id.binary())

    def _unindex_owned(self, e: ObjectEntry) -> None:
        held = self._owned.get(e.owned_by) if e.owned_by else None
        if held is not None:
            held.discard(e.object_id.binary())
            if not held:
                del self._owned[e.owned_by]

    def _h_put_object(self, identity: bytes, m: dict) -> None:
        e = self._entry(m["object_id"])
        e.owner = e.owner or identity
        if e.owned_by is None:
            self._set_owned_by(e, identity)
        if m.get("inline") is not None:
            e.inline = m["inline"]
            e.size = len(e.inline)
        if m.get("node_id"):
            e.locations.add(m["node_id"])
            e.size = m.get("size", e.size)
            # transfer (if any) completed: allow future re-pulls to this
            # node after it frees its copy
            self._transfers.pop((m["object_id"], m["node_id"]), None)
        if m.get("error") is not None:
            e.error = m["error"]
        self._object_created(m["object_id"])
        if m.get("rid"):
            self._reply(identity, m["rid"], {"ok": True})

    def _object_created(self, object_id_b: bytes) -> None:
        """Wake tasks waiting on this object + local-waiters now satisfiable."""
        e = self.objects.get(object_id_b)
        for task_id in list(self.dep_waiters.pop(object_id_b, ())):
            t = self.tasks.get(task_id)
            if t is None:
                continue
            t.deps_remaining.discard(object_id_b)
            if t.state == "PENDING_DEPS" and not t.deps_remaining:
                self._enqueue_ready(task_id, t)
            elif t.state == "PENDING_TRANSFER":
                t.transfers_remaining.discard(object_id_b)
                if not t.transfers_remaining:
                    self._dispatch(task_id)
        self._waiter_since.pop(object_id_b, None)
        self._hole_strikes.pop(object_id_b, None)
        self._owner_fetches.pop(object_id_b, None)
        waiters = self.local_waiters.pop(object_id_b, [])
        for identity, rid in waiters:
            self._answer_location(identity, rid, object_id_b)
        self._maybe_schedule()

    def _h_get_location(self, identity: bytes, m: dict) -> None:
        object_id_b = m["object_id"]
        e = self.objects.get(object_id_b)
        if e is not None and (e.inline is not None or e.error is not None or e.locations):
            self._answer_location(identity, m["rid"], object_id_b,
                                  want_node=m.get("want_node"))
        else:
            # not created yet (or lost) — try lineage reconstruction, else
            # wait (the audit probes node stores for long-parked waiters:
            # probing here would broadcast on every ordinary
            # get-before-producer-finishes, the hot borrower path)
            if e is not None and e.lineage_task is not None and not e.locations \
                    and e.inline is None and e.error is None:
                self._reconstruct(e)
            elif e is None and object_id_b not in self._waiter_since:
                self._waiter_since[object_id_b] = time.monotonic()
            owner_b = m.get("owner")
            if owner_b and owner_b != identity and e is None \
                    and object_id_b not in self._owner_fetches:
                # owner-local object (never published): ask the owner to
                # publish its value; the PUT_OBJECT it sends resolves
                # this waiter through _object_created
                self._owner_fetches[object_id_b] = owner_b
                self._send(owner_b, P.FETCH_OBJECT,
                           {"object_id": object_id_b})
            self.local_waiters[object_id_b].append((identity, m["rid"]))

    def _answer_location(self, identity: bytes, rid: bytes, object_id_b: bytes,
                         want_node: Optional[bytes] = None) -> None:
        e = self.objects.get(object_id_b)
        if e is None:
            # raced with a release: answering with an error beats the
            # KeyError that used to swallow the reply and hang the get
            from ray_tpu_torch.exceptions import ObjectLostError
            self._reply(identity, rid, {"error": P.dumps(
                ObjectLostError(ObjectID(object_id_b),
                                "freed before the location lookup"))})
            return
        if e.error is not None:
            self._reply(identity, rid, {"error": e.error})
            return
        if e.inline is not None:
            self._reply(identity, rid, {"inline": e.inline})
            return
        peer = self.peers.get(identity, {})
        want_node = want_node or peer.get("node_id")
        if want_node and want_node not in e.locations and e.locations:
            self._start_transfer(object_id_b, want_node)
            self.local_waiters[object_id_b].append((identity, rid))
            return
        if not e.locations:
            if e.lineage_task is not None:
                self._reconstruct(e)
                self.local_waiters[object_id_b].append((identity, rid))
                return
            from ray_tpu_torch.exceptions import ObjectLostError
            self._reply(identity, rid,
                        {"error": P.dumps(ObjectLostError(e.object_id))})
            return
        self._reply(identity, rid, {"node_id": next(iter(e.locations)),
                                    "size": e.size})

    def _start_transfer(self, object_id_b: bytes, dest_node: bytes) -> None:
        """Ask the destination node to pull the object from a holder.
        The controller hands out the source address ONLY — the bytes move
        node-to-node over the direct channel (reference: the pull manager
        lives on the receiving object manager, pull_manager.h:52, and
        chunks never transit the GCS)."""
        self._begin_transfer(object_id_b, dest_node, attempt=1)

    def _begin_transfer(self, object_id_b: bytes, dest_node: bytes,
                        attempt: int) -> None:
        key = (object_id_b, dest_node)
        if key in self._transfers:
            return
        e = self.objects.get(object_id_b)
        if e is None or not e.locations:
            return
        src = next(iter(e.locations))
        src_node = self.nodes.get(src)
        dest = self.nodes.get(dest_node)
        if src_node is None or dest is None:
            return
        self._transfers[key] = attempt
        self._send(dest.identity, P.PULL_OBJECT, {
            "object_id": object_id_b, "src_identity": src_node.identity,
            "src_node": src, "size": e.size})

    def _h_pull_failed(self, identity: bytes, m: dict) -> None:
        """A destination node could not pull an object. If the SOURCE
        reported it missing (stale_src), drop that location; dest-local
        causes (timeout, store pressure) keep the holder. Retry from a
        holder up to a cap, then reconstruct via lineage or fail every
        waiter with ObjectLostError — never leave them hanging."""
        b = m["object_id"]
        e = self.objects.get(b)
        peer = self.peers.get(identity, {})
        dest_node = peer.get("node_id")
        attempts = 0
        if dest_node is not None:
            attempts = self._transfers.pop((b, dest_node), 0)
        if e is None:
            return
        src = m.get("src_node")
        if src is not None and m.get("stale_src"):
            e.locations.discard(src)
        if dest_node is None:
            return
        if e.locations and attempts < 5:
            self._begin_transfer(b, dest_node, attempts + 1)
        elif e.lineage_task is not None:
            self._reconstruct(e)
        else:
            self._fail_object_waiters(b, e)

    def _fail_object_waiters(self, b: bytes, e: ObjectEntry) -> None:
        from ray_tpu_torch.exceptions import ObjectLostError
        err = P.dumps(ObjectLostError(e.object_id))
        for identity, rid in self.local_waiters.pop(b, []):
            self._reply(identity, rid, {"error": err})
        for tid in list(self.dep_waiters.pop(b, ())):
            self._handle_task_failure(
                tid, f"object {ObjectID(b).hex()[:12]} lost in transfer")

    def _h_ref_deltas(self, identity: bytes, m: dict) -> None:
        self.refs.apply_deltas(m["deltas"], holder=identity)

    def _release_dead_holder(self, identity: bytes) -> None:
        """A process died: release the refs it held, and the objects it
        owned that no count holds (their first deltas died with it). The
        usual grace window applies, so a borrower's +1 still in flight
        keeps its object."""
        self.refs.release_holder(identity)
        for b in self._owned.pop(identity, ()):
            e = self.objects.get(b)
            if e is not None and e.owned_by == identity \
                    and self.refs.count(e.object_id) <= 0 \
                    and self.refs.force_release(b):
                self._queue_refcount_zero(e.object_id)

    def _h_lease_workers(self, identity: bytes, m: dict) -> None:
        """Grant idle workers to a driver for direct task submission.
        Each grant holds the worker's CPU until released/reclaimed.
        Under load there are no idle workers at request time, so the
        remainder is PARKED and granted as workers free up (pushed via
        LEASE_GRANT — the reference's lease requests queue in the
        raylet the same way)."""
        want = int(m.get("count", 1))
        granted = self._grant_leases(identity, want)
        self._reply(identity, m["rid"], {"workers": granted})
        remaining = want - len(granted)
        if remaining > 0:
            # one parked entry per driver (latest wins)
            self._pending_leases = [
                (d, n) for d, n in self._pending_leases if d != identity]
            self._pending_leases.append((identity, remaining))
            # multi-driver fairness: if another driver is hogging the
            # worker pool, rebalance toward this request now
            self._rebalance_leases()

    def _lease_quota(self) -> int:
        """Per-driver lease cap while several drivers want capacity.
        Measured rationale (perf multi_client phase): with one driver
        holding every CPU, the other drivers bounce between empty
        grants and the controller path, feeding the starvation
        reclaimer — aggregate throughput of 4 drivers fell BELOW one.
        An equal split keeps every driver on the direct path."""
        claimants = set(self.driver_leases.values())
        claimants.update(d for d, _ in self._pending_leases)
        n = max(1, len(claimants))
        # leasable capacity only: actor-dedicated workers can never be
        # granted, so counting them inflates the quota and lets one
        # driver hold every leasable worker without tripping rebalance
        capacity = sum(
            1 for node in self.nodes.values() if node.alive
            for w in node.all_workers if w not in self.worker_actors)
        # ceil: a floor quota would strand capacity % n workers idle
        # forever (every driver clamped below them)
        return max(1, -(-capacity // n))

    def _grant_leases(self, identity: bytes, want: int) -> List[bytes]:
        if self._pending_leases or len(
                set(self.driver_leases.values()) - {identity}) > 0:
            # other drivers hold or want leases: stay inside the quota
            have = sum(1 for d in self.driver_leases.values()
                       if d == identity)
            want = min(want, max(0, self._lease_quota() - have))
        granted: List[bytes] = []
        for node in self.nodes.values():
            if not node.alive:
                continue
            # never grant below the controller queue's own needs
            if node.stats.get("wait_worker"):
                continue
            while want > 0:
                w = next((w for w in node.idle_workers
                          if w not in self._gpu_workers), None)
                if w is None or not self.scheduler.try_acquire(
                        node.node_id, {"CPU": 1.0}):
                    break
                node.idle_workers.remove(w)
                self.driver_leases[w] = identity
                self._lease_node[w] = node.node_id.binary()
                granted.append(w)
                want -= 1
            if want <= 0:
                break
        return granted

    def _grant_parked_leases(self) -> None:
        if not self._pending_leases:
            return
        if self.ready_queues:
            # queued controller-path tasks outrank parked lease
            # requests — granting here would re-take the CPU a
            # starvation reclaim just freed (revoke/grant thrash)
            return
        still: List[tuple] = []
        for driver, n in self._pending_leases:
            got = self._grant_leases(driver, n)
            if got:
                self._send(driver, P.LEASE_GRANT, {"workers": got})
            if len(got) < n:
                still.append((driver, n - len(got)))
        self._pending_leases = still

    def _rebalance_leases(self) -> None:
        """Revoke over-quota leases from hogging drivers so parked
        requests of under-quota drivers can be granted (reference: the
        raylet returns leased workers when other lease requests queue;
        here the quota makes the split explicit). Stable: only drivers
        ABOVE the quota lose leases, only down to the quota."""
        if not self._pending_leases:
            return
        quota = self._lease_quota()
        counts: Dict[bytes, int] = {}
        for d in self.driver_leases.values():
            counts[d] = counts.get(d, 0) + 1
        pending = {d for d, _ in self._pending_leases
                   if counts.get(d, 0) < quota}
        if not pending:
            return
        for w, d in list(self.driver_leases.items()):
            if counts.get(d, 0) <= quota:
                continue
            if w in self._lease_blocked:
                continue
            counts[d] -= 1
            self._send(d, P.LEASE_REVOKED, {"worker": w, "dead": False})
            self._reclaim_driver_lease(w)
        self._grant_parked_leases()

    def _h_release_leases(self, identity: bytes, m: dict) -> None:
        for w in m.get("workers", ()):
            self._reclaim_driver_lease(w)

    def _reclaimable_lease_for(self, demand, strategy) -> Optional[bytes]:
        """A driver-held lease whose reclaim could actually unblock
        ``demand``: its node must satisfy the demand once the lease's
        reserved {"CPU": 1.0} is returned. Returns None when no reclaim
        can help — demand needing resources no lease holds, demand
        requiring CPU the lease doesn't cover, PLACEMENT_GROUP tasks
        (their blocking condition is the bundle reservation, not node
        CPU), or node-pinned tasks whose pin excludes the lease's node."""
        if not demand.get("CPU"):
            # reclaiming frees only CPU; CPU-free demand can't benefit
            # (PG tasks reach here too: _sched_res gives them {})
            return None
        # group reclaimable leases by node: a multi-CPU demand may need
        # several reclaims (one per drain) on the same node to place, so
        # the test is "would freeing ALL this node's leases satisfy it"
        by_node: Dict[bytes, List[bytes]] = {}
        for w in self.driver_leases:
            if w in self._lease_blocked:
                continue
            node_b = self._lease_node.get(w)
            if node_b is not None:
                by_node.setdefault(node_b, []).append(w)
        for node_b, leases in by_node.items():
            node = self.scheduler.get_node(NodeID(node_b))
            if node is None or not node.alive or node.draining:
                continue
            if strategy.kind == "NODE_AFFINITY" and \
                    strategy.node_id is not None and \
                    strategy.node_id.binary() != node_b and \
                    not strategy.soft:
                continue
            if strategy.kind == "NODE_LABEL" and any(
                    node.labels.get(k) not in allowed
                    for k, allowed in strategy.hard_labels.items()):
                continue
            if all(node.available.get(k, 0.0)
                   + (float(len(leases)) if k == "CPU" else 0.0) + 1e-9
                   >= v for k, v in demand.items()):
                return leases[0]
        return None

    def _reclaim_driver_lease(self, worker: bytes) -> None:
        if self.driver_leases.pop(worker, None) is None:
            return
        node_b = self._lease_node.pop(worker, None)
        was_blocked = worker in self._lease_blocked
        self._lease_blocked.discard(worker)
        node = self.nodes.get(node_b) if node_b else None
        if node is not None and node.alive:
            if was_blocked:
                # serial thread is sitting in ray.get: idle-pooling it
                # now would bounce every dispatch (handback spin). Park
                # it; NOTIFY_UNBLOCKED returns it to the pool.
                self._blocked_orphans.add(worker)
                return
            self._release_res(NodeID(node_b), {"CPU": 1.0})
            if worker in node.all_workers:
                self._return_worker(worker)

    def _reclaim_driver_leases_of(self, driver: bytes) -> None:
        for w in [w for w, d in self.driver_leases.items() if d == driver]:
            self._reclaim_driver_lease(w)
        self._pending_leases = [
            (d, n) for d, n in self._pending_leases if d != driver]

    def _audit_driver_leases(self) -> None:
        """Reclaim leases (and parked lease requests) whose driver has
        gone silent — a crashed driver must not pin worker CPUs forever.
        Drivers ping every 2s; 30s of silence is decisive."""
        if not self.driver_leases and not self._pending_leases:
            return
        now = time.monotonic()
        drivers = set(self.driver_leases.values()) | {
            d for d, _ in self._pending_leases}
        for d in drivers:
            info = self.peers.get(d)
            last = (info or {}).get("last_seen")
            if info is None or (last is not None and now - last > 30.0):
                logger.warning(
                    "reclaiming worker leases of silent driver %s",
                    d.hex()[:8] if isinstance(d, bytes) else d)
                self._reclaim_driver_leases_of(d)

    def _h_owner_free(self, identity: bytes, m: dict) -> None:
        """The owner already evicted these never-shared extents from the
        segment (eager owner-side GC); drop metadata, waiters, and node
        bookkeeping. Node-side FREE_OBJECT is idempotent on an
        already-evicted extent."""
        for b in m["object_ids"]:
            if self.refs.force_release(b):
                self._on_refcount_zero(ObjectID(b))

    def _queue_refcount_zero(self, object_id: ObjectID) -> None:
        self._pending_frees[object_id.binary()] = \
            time.monotonic() + self.config.free_grace_s

    def _drain_pending_frees(self) -> None:
        """Health-loop: run frees whose grace expired and whose count
        did not resurrect meanwhile (a positive delta clears the
        tombstone, making is_released False)."""
        if not self._pending_frees:
            return
        now = time.monotonic()
        due = [b for b, t in self._pending_frees.items() if t <= now]
        for b in due:
            del self._pending_frees[b]
            if self.refs.is_released(b):
                self._on_refcount_zero(ObjectID(b))

    def _on_refcount_zero(self, object_id: ObjectID) -> None:
        b = object_id.binary()
        entry = self.objects.get(b)
        has_waiters = bool(self.dep_waiters.get(b)
                           or self.local_waiters.get(b))
        if has_waiters and entry is not None and (
                entry.inline is not None or entry.locations
                or entry.lineage_task is not None):
            # Someone is actively waiting AND the object is still
            # materializable: the zero is a transient artifact of delta
            # batching (the waiter holds a live ref whose +1 is still in
            # flight). Freeing now would strand the parked tasks — keep
            # the object; the pending +1 resurrects the count and a
            # later real zero retries the free.
            self.refs.cancel_release(b)
            return
        e = self.objects.pop(b, None)
        if e is not None:
            self._unindex_owned(e)
        # Unrecoverable (no entry, or entry with no way to materialize):
        # fail the waiters loudly rather than stranding them.
        for tid in list(self.dep_waiters.pop(b, ())):
            self._handle_task_failure(
                tid, f"object {ObjectID(b).hex()[:12]} freed while the "
                f"task waited on it", retriable=False)
        waiters = self.local_waiters.pop(b, [])
        if waiters:
            from ray_tpu_torch.exceptions import ObjectLostError
            err = P.dumps(ObjectLostError(object_id,
                                          "freed: refcount zero"))
            for identity, rid in waiters:
                self._reply(identity, rid, {"error": err})
        if e is None:
            return
        for node_b in e.locations:
            node = self.nodes.get(node_b)
            if node is not None:
                self._send(node.identity, P.FREE_OBJECT, {"object_id": b})

    # --------------------------------------------------------------- tasks
    def _h_submit_batch(self, identity: bytes, m: dict) -> None:
        """Pipelined submission: many specs in one message (reference:
        lease reuse + pipelined submission, direct_task_transport.h:157 —
        here the batching is at the wire layer). One schedule drain for the
        whole batch."""
        for spec in m["specs"]:
            self._h_submit_task(identity, {"spec": spec}, defer_schedule=True)
        self._maybe_schedule()

    def _h_submit_task(self, identity: bytes, m: dict,
                       defer_schedule: bool = False) -> None:
        spec: TaskSpec = m["spec"]
        if spec.is_actor_task:
            self._submit_actor_task(identity, spec)
            return
        # owner-side dependency seeding (see TaskSpec.arg_metas): fill
        # directory holes for args the owner already knows
        for b, am in (spec.arg_metas or {}).items():
            e = self.objects.get(b)
            if e is None or (e.inline is None and e.error is None
                             and not e.locations):
                e = self._entry(b)
                if am.get("inline") is not None:
                    e.inline = am["inline"]
                if am.get("node_id"):
                    e.locations.add(am["node_id"])
                e.size = e.size or am.get("size", 0)
                self._object_created(b)
        t = PendingTask(spec=spec, retries_left=spec.max_retries,
                        submitted_at=time.monotonic())
        tid = spec.task_id.binary()
        self.tasks[tid] = t
        self.task_table[tid] = {
            "task_id": spec.task_id.hex(), "name": spec.name or str(spec.function),
            "state": "PENDING_ARGS_AVAIL", "type": "ACTOR_CREATION_TASK"
            if spec.is_actor_creation else "NORMAL_TASK",
            "submitted_at": time.time(),
        }
        # phase 1: wait for all arg objects to exist somewhere
        for _, oid in spec.arg_refs:
            b = oid.binary()
            e = self.objects.get(b)
            if e is None or (e.inline is None and e.error is None and not e.locations):
                t.deps_remaining.add(b)
                self.dep_waiters[b].add(tid)
                if e is not None and e.lineage_task is not None:
                    self._reconstruct(e)
        if not t.deps_remaining:
            self._enqueue_ready(tid, t)
            if not defer_schedule:
                self._maybe_schedule()

    @staticmethod
    def _sched_res(spec: TaskSpec) -> Dict[str, float]:
        """Placement-group tasks consume pre-reserved bundle resources, not
        fresh node capacity (reference: bundle resources are renamed
        `CPU_group_<pgid>` instances; here the reservation itself is the
        accounting)."""
        if spec.scheduling_strategy.kind == "PLACEMENT_GROUP":
            return {}
        return spec.resources

    def _enqueue_ready(self, tid: bytes, t: PendingTask) -> None:
        """Mark a task ready and file it under its scheduling class."""
        t.state = "QUEUED"
        self._sched_dirty = True
        if t.shape_key is None:
            strat = t.spec.scheduling_strategy
            if t.spec.is_actor_creation:
                # never pipelined onto a shared lease (pins its worker)
                t.shape_key = (tid,)
            elif strat.kind in ("DEFAULT", "SPREAD"):
                t.shape_key = (strat.kind,
                               tuple(sorted(self._sched_res(t.spec).items())))
            else:
                # node-affinity / PG / label strategies are evaluated
                # per-task: give each its own class
                t.shape_key = (tid,)
        q = self.ready_queues.get(t.shape_key)
        if q is None:
            q = self.ready_queues[t.shape_key] = collections.deque()
        q.append(tid)

    def _lease_depth(self, key: Optional[tuple]) -> int:
        # SPREAD classes don't pipeline (piling tasks on one worker would
        # defeat the strategy); DEFAULT classes ride the full depth
        if key and key[0] == "SPREAD":
            return 1
        return max(1, self.config.dispatch_pipeline_depth)

    def _refill_lease(self, lease: Lease) -> None:
        """Pipeline tasks of the lease's scheduling class onto its worker up
        to the configured depth — no new resource acquisition, no pick_node
        (reference: OnWorkerIdle). The single refill path for every caller."""
        q = self.ready_queues.get(lease.shape_key)
        if not q or lease.blocked:
            return
        depth = self._lease_depth(lease.shape_key)
        while q and len(lease.inflight) < depth:
            tid = q.popleft()
            t = self.tasks.get(tid)
            if t is None or t.state != "QUEUED":
                continue
            self._dispatch_on_lease(lease, tid, t)

    def _fill_leases_for_class(self, key: tuple, q: Deque[bytes]) -> None:
        for w in list(self.class_leases.get(key, ())):
            if not q:
                return
            lease = self.leases.get(w)
            if lease is None:
                self.class_leases[key].discard(w)
                continue
            self._refill_lease(lease)

    def _release_res(self, node_id, resources) -> None:
        """Release node resources AND mark the scheduler dirty: freed
        capacity can admit queued work."""
        self.scheduler.release(node_id, resources)
        self._sched_dirty = True

    def _maybe_schedule(self, force: bool = False) -> None:
        """Drain the ready queues (reference:
        ClusterTaskManager::ScheduleAndDispatchTasks). A scheduling class
        that fails to place blocks only itself, and the drain costs
        O(#classes + #dispatched) — not O(#queued tasks).

        Event-driven: a no-op unless capacity or demand changed since the
        last drain (``_sched_dirty``). Lease pipelines refill inline at
        completion (_lease_housekeeping), so a full drain per TASK_DONE
        would re-scan every class x lease for nothing — measured at ~30%
        of controller CPU on the async-task hot path. The health loop
        forces a periodic drain as a self-healing backstop."""
        if not self._sched_dirty and not force:
            return
        self._sched_dirty = False
        self._prestart_for_actor_demand()
        if self.ready_queues:
            empties = []
            for key, q in self.ready_queues.items():
                self._fill_leases_for_class(key, q)
                while q:
                    tid = q[0]
                    t = self.tasks.get(tid)
                    if t is None or t.state != "QUEUED":
                        q.popleft()
                        continue
                    node_id = self.scheduler.pick_node(
                        self._sched_res(t.spec), t.spec.scheduling_strategy)
                    if node_id is None:
                        # driver-held worker leases can starve the queue
                        # (their CPU is reserved): reclaim one per drain —
                        # but only a lease whose freed CPU would make THIS
                        # demand placeable on its node. Demand infeasible
                        # for other reasons (e.g. a custom resource no
                        # node provides) must not dismantle the
                        # direct-transport lease pool one drain at a time.
                        # BLOCKED leases are exempt — their CPU is
                        # already released, and returning a worker whose
                        # serial thread sits in ray.get to the idle pool
                        # wedges the cluster in a dispatch/bounce loop.
                        w = self._reclaimable_lease_for(
                            self._sched_res(t.spec),
                            t.spec.scheduling_strategy)
                        if w is not None:
                            driver = self.driver_leases.get(w)
                            self._reclaim_driver_lease(w)
                            if driver is not None:
                                # worker is alive: its queued direct
                                # tasks still complete — no resubmit
                                self._send(driver, P.LEASE_REVOKED,
                                           {"worker": w, "dead": False})
                            self._sched_dirty = True
                        break  # class infeasible right now; try next class
                    q.popleft()
                    self._assign_node(tid, t, node_id)
                if not q:
                    empties.append(key)
            for key in empties:
                del self.ready_queues[key]
        if self._maybe_place_pgs():
            # a freshly-placed gang can unblock queued work pinned to
            # its bundles (actor creations waiting on the reservation):
            # drain once more now instead of waiting for the health
            # loop's forced pass
            self._sched_dirty = True
            self._maybe_schedule()

    def _assign_node(self, tid: bytes, t: PendingTask, node_id: NodeID) -> None:
        t.node_id = node_id
        self.task_table[tid]["state"] = "PENDING_NODE_ASSIGNMENT"
        # phase 2: ensure deps local to the chosen node
        node_b = node_id.binary()
        for _, oid in t.spec.arg_refs:
            b = oid.binary()
            e = self.objects.get(b)
            if e is None or e.inline is not None or e.error is not None:
                continue
            if node_b not in e.locations:
                t.transfers_remaining.add(b)
                self.dep_waiters[b].add(tid)
                self._start_transfer(b, node_b)
        if t.transfers_remaining:
            t.state = "PENDING_TRANSFER"
        else:
            self._dispatch(tid)

    def _dispatch(self, tid: bytes) -> None:
        t = self.tasks.get(tid)
        if t is None or t.node_id is None:
            return
        node = self.nodes.get(t.node_id.binary())
        if node is None or not node.alive:
            self._handle_task_failure(tid, "node died before dispatch")
            return
        if not node.idle_workers:
            # ask the node to start a worker; re-dispatch when it registers.
            # The pool of TASK workers is capped at the node's CPU count
            # (reference: worker_pool.cc sizes to num_cpus) — more workers
            # than cores just adds scheduler churn. Actor-pinned workers are
            # dedicated (reference: dedicated actor workers) and do NOT
            # count against the cap, else long-lived actors starve tasks.
            cap = max(1, int(node.resources.total.get("CPU", 1)))
            task_workers = sum(1 for w in node.all_workers
                               if w not in self.worker_actors)
            # zero-footprint tasks (num_cpus=0, placement-group bundles) are
            # admitted by the scheduler without consuming CPU, so demand can
            # legitimately exceed the cap — every admitted task must get a
            # worker eventually or gang workloads deadlock (reference:
            # a granted lease always gets a worker).
            waiting = len(node.stats.get("wait_worker") or ()) + 1
            if node.starting_workers + task_workers < cap or \
                    node.starting_workers < waiting:
                node.starting_workers += 1
                self._send(node.identity, P.TASK_ASSIGN, {"start_worker": True})
            t.state = "QUEUED_WORKER"
            self._waiting_for_worker(node, tid)
            return
        worker = self._pick_idle_worker(node, t.spec)
        self._dispatch_to_worker(tid, node, worker)

    def _prestart_for_actor_demand(self) -> None:
        """Spawn-ahead for actor bursts (VERDICT r4 #4; reference:
        worker_pool.h:104 PrestartWorkers sized by queued demand): every
        queued actor CREATION will need a fresh dedicated worker, but
        CPU admission only lets ~num_cpus creations run at once — if the
        worker spawn starts inside the admission slot, each wave pays
        full boot latency serially. Counting queued creations and
        spawning that many workers NOW (bounded, zygote-forked in ms)
        means every admitted creation finds a registered idle worker.
        Rate-limited: a pass runs at most once per 250ms."""
        now = time.monotonic()
        if now - self._last_actor_prestart < 0.25:
            return
        pending = 0
        for q in self.ready_queues.values():
            for tid in q:
                t = self.tasks.get(tid)
                if t is not None and t.spec.is_actor_creation:
                    pending += 1
        if not pending:
            return
        self._last_actor_prestart = now
        # bounded spawn-ahead: admission is ~num_cpus wide, so a few
        # dozen warm spares keep the pipeline full; forking the WHOLE
        # backlog at once just builds a 100-deep runqueue whose
        # scheduling thrash slows every boot (measured: 96-wide storm
        # registered workers at 2/s vs 40/s uncontended)
        remaining = min(pending, 48)
        alive = [n for n in self.nodes.values() if n.alive]
        for i, node in enumerate(alive):
            if remaining <= 0:
                break
            # even split of the outstanding demand across nodes, less
            # what each already has ready or starting
            share = -(-remaining // (len(alive) - i))
            ready = len(node.idle_workers) + node.starting_workers
            want = max(0, share - ready)
            for _ in range(want):
                node.starting_workers += 1
                self._send(node.identity, P.TASK_ASSIGN,
                           {"start_worker": True})
            remaining -= share

    def _prestart_workers(self) -> None:
        """Warm the pool when a driver connects (reference:
        prestart_worker_first_driver / worker_pool.cc PrestartWorkers):
        the driver's first task burst then lands on live workers instead
        of paying process-spawn latency serially."""
        target = self.config.prestart_workers
        if target <= 0:
            return
        for node in self.nodes.values():
            if not node.alive:
                continue
            cap = max(1, int(node.resources.total.get("CPU", 1)))
            want = min(target, cap)
            have = len(node.all_workers) + node.starting_workers
            for _ in range(max(0, want - have)):
                node.starting_workers += 1
                self._send(node.identity, P.TASK_ASSIGN,
                           {"start_worker": True})

    def _pick_idle_worker(self, node: NodeInfo, spec) -> bytes:
        """Prefer an idle worker whose last-applied runtime env matches
        the task's (reference: runtime-env-keyed worker pools,
        worker_pool.cc — avoids re-mounting working_dir/py_modules and
        env-var churn on shared workers). Falls back to FIFO. A spec that
        asks for GPU takes a worker that has run one first."""
        env = getattr(spec, "runtime_env", None)
        key = repr(sorted(env.items())) if env else ""
        if spec.resources.get("GPU"):
            # a worker that already holds the card: no second context
            for i, w in enumerate(node.idle_workers):
                if w in self._gpu_workers:
                    del node.idle_workers[i]
                    self._worker_env[w] = key
                    return w
        for i, w in enumerate(node.idle_workers):
            if self._worker_env.get(w, "") == key:
                del node.idle_workers[i]
                return w
        w = node.idle_workers.popleft()
        self._worker_env[w] = key
        return w

    def _waiting_for_worker(self, node: NodeInfo, tid: bytes) -> None:
        node.stats.setdefault("wait_worker", collections.deque()).append(tid)

    def _drain_waiting_tasks(self, node: NodeInfo) -> None:
        waiting = node.stats.get("wait_worker")
        while waiting and node.idle_workers:
            tid = waiting.popleft()
            if tid in self.tasks:
                worker = self._pick_idle_worker(
                    node, self.tasks[tid].spec)
                self._dispatch_to_worker(tid, node, worker)

    def _dispatch_to_worker(self, tid: bytes, node: NodeInfo, worker: bytes) -> None:
        t = self.tasks[tid]
        if t.spec.resources.get("GPU"):
            self._gpu_workers.add(worker)
        if t.spec.is_actor_creation:
            t.worker = worker
            t.state = "RUNNING"
            self.task_table[tid].update(
                state="RUNNING", node=t.node_id.hex() if t.node_id else None,
                started_at=time.time())
            self.recorder.record_task(
                EV.DISPATCHED, t.spec.task_id.hex(), t.spec.trace,
                worker=worker.hex()[:12])
            self._send_dispatch(worker, t)
            aid = t.spec.actor_id.binary()
            info = self.actors.get(aid)
            if info is not None:
                info.state = "STARTING"
                info.node_id = t.node_id
            self.actor_workers[aid] = worker
            self.worker_actors[worker] = aid
            # the node's OOM killer should prefer stateless task workers
            self._send(node.identity, P.WORKER_PINNED,
                       {"worker_identity": worker})
            return
        # open a lease: the task's resource acquisition (made at pick_node)
        # transfers to the lease and is released when the lease closes
        lease = Lease(worker=worker, node_b=node.node_id.binary(),
                      shape_key=t.shape_key or (tid,),
                      resources=self._sched_res(t.spec))
        self.leases[worker] = lease
        self.class_leases[lease.shape_key].add(worker)
        self._dispatch_on_lease(lease, tid, t)
        self._refill_lease(lease)

    def _dispatch_on_lease(self, lease: Lease, tid: bytes, t: PendingTask) -> None:
        t.node_id = NodeID(lease.node_b)
        t.worker = lease.worker
        t.state = "RUNNING"
        lease.inflight.add(tid)
        self.task_table[tid].update(state="RUNNING", node=t.node_id.hex(),
                                    started_at=time.time())
        self.recorder.record_task(
            EV.LEASED, t.spec.task_id.hex(), t.spec.trace,
            worker=lease.worker.hex()[:12],
            queue_s=round(time.monotonic() - t.submitted_at, 6))
        self.recorder.record_task(
            EV.DISPATCHED, t.spec.task_id.hex(), t.spec.trace,
            worker=lease.worker.hex()[:12])
        self._send_dispatch(lease.worker, t)

    def _send_dispatch(self, worker: bytes, t: PendingTask) -> None:
        """Message assembly + send only — callers own all state mutation."""
        inline_args = {}
        errors = {}
        for _, oid in t.spec.arg_refs:
            e = self.objects.get(oid.binary())
            if e is None:
                continue
            if e.error is not None:
                errors[oid.binary()] = e.error
            elif e.inline is not None:
                inline_args[oid.binary()] = e.inline
        self._send(worker, P.TASK_DISPATCH, {
            "spec": t.spec, "inline_args": inline_args, "arg_errors": errors})

    def _lease_housekeeping(self, worker: bytes, lease: Lease) -> None:
        """After a completion on a leased worker: refill its pipeline from
        the class queue, or close the lease when the class has drained."""
        self._refill_lease(lease)
        if not lease.inflight and not lease.blocked and \
                not self.ready_queues.get(lease.shape_key):
            self._close_lease(worker, lease)

    def _close_lease(self, worker: bytes, lease: Lease) -> None:
        self.leases.pop(worker, None)
        peers = self.class_leases.get(lease.shape_key)
        if peers is not None:
            peers.discard(worker)
            if not peers:
                self.class_leases.pop(lease.shape_key, None)
        node = self.nodes.get(lease.node_b)
        if node is not None and node.alive and not lease.blocked:
            # a blocked lease already released its allocation
            self._release_res(NodeID(lease.node_b), lease.resources)
        self._return_worker(worker)

    def _h_task_done(self, identity: bytes, m: dict) -> None:
        tid = m["task_id"]
        self.recorder.record_task(
            EV.FAILED if m.get("error") is not None else EV.FINISHED,
            TaskID(tid).hex(), m.get("trace"),
            worker=identity.hex()[:12])
        # Duplicate executions happen (at-least-once resubmission racing
        # a completion already in flight): lease/worker bookkeeping below
        # must still run for WHICHEVER worker executed, but result
        # recording is first-wins — see _record_result_entry.
        if m.get("driver_leased") and not m.get("is_actor_task"):
            # direct driver-leased execution (flag set at dispatch, so
            # this holds even after the lease was reclaimed): the
            # controller never saw the task — record results and
            # observability only; resources are held by the grant
            self.task_table[tid] = {
                "task_id": TaskID(tid).hex(), "type": "NORMAL_TASK",
                "state": "FAILED" if m.get("error") else "FINISHED",
                "finished_at": time.time(), "leased": True}
            if m.get("error") is not None and m.get("retriable") \
                    and m.get("spec") is not None:
                spec: TaskSpec = m["spec"]
                if spec.max_retries != 0:
                    if spec.max_retries > 0:
                        spec.max_retries -= 1
                    # re-route the retry through the normal scheduler
                    self._h_submit_task(m.get("owner") or identity,
                                        {"spec": spec})
                    return
            recorded = []
            for r in m.get("results", []):
                if r.get("inline") is None and not r.get("node_id"):
                    # owner-local result (inline meta trimmed by the
                    # worker, or a bare error result): the owner holds
                    # the value/error and its lifecycle — no directory
                    # entry, no refcounts (recording an error entry here
                    # would leak it forever: the owner never promoted
                    # these returns, so no deltas ever arrive). A parked
                    # borrower resolves via FETCH_OBJECT, so it must NOT
                    # be woken (and failed) here. Crash-window caveat,
                    # matching the reference's in-process store: if the
                    # worker dies with its direct TASK_RESULT unflushed,
                    # the value is unrecoverable (no controller backup).
                    continue
                if self.refs.is_released(r["object_id"]) and \
                        r["object_id"] not in self._pending_frees:
                    # zero confirmed past the grace window: don't
                    # resurrect. Grace-pending zeros still record — the
                    # deferred free (or a resurrecting +1) decides.
                    # Still wake waiters (pre-change behavior): a parked
                    # get on a freed object should fail now, not hang.
                    recorded.append(r["object_id"])
                    continue
                e = self._entry(r["object_id"])
                e.owner = m.get("owner", identity)
                self._set_owned_by(e, e.owner)
                e.size = r.get("size", 0)
                if r.get("inline") is not None:
                    e.inline = r["inline"]
                if r.get("node_id"):
                    e.locations.add(r["node_id"])
                if m.get("error") is not None and e.inline is None \
                        and not e.locations:
                    # first-wins: a duplicate execution (at-least-once
                    # resubmit) failing on since-freed args must not
                    # poison an object that already has data
                    e.error = m["error"]
                recorded.append(r["object_id"])
            for b in recorded:
                self._object_created(b)
            return
        if m.get("owner_report"):
            # the OWNER reports a task that will never execute (dead
            # actor): record the error objects and wake their waiters —
            # no lease/worker bookkeeping (identity is not an executor)
            self.tasks.pop(tid, None)
            for r in m.get("results", []):
                e = self._entry(r["object_id"])
                e.owner = identity
                e.error = m.get("error")
            for r in m.get("results", []):
                self._object_created(r["object_id"])
            return
        t = self.tasks.pop(tid, None)
        lease = self.leases.get(identity)
        if lease is not None:
            lease.inflight.discard(tid)
        row = self.task_table.get(tid)
        if row is not None:
            row["state"] = "FAILED" if m.get("error") else "FINISHED"
            row["finished_at"] = time.time()
        elif m.get("is_actor_task"):
            # direct actor call: first (and only) controller sighting
            aid_hex = None
            a = self.worker_actors.get(identity)
            if a is not None:
                aid_hex = ActorID(a).hex()
            self.task_table[tid] = {
                "task_id": TaskID(tid).hex(), "type": "ACTOR_TASK",
                "state": "FAILED" if m.get("error") else "FINISHED",
                "actor_id": aid_hex, "finished_at": time.time()}
        if t is not None:
            is_actor_task = t.spec.is_actor_task
            is_actor_creation = t.spec.is_actor_creation
        else:
            is_actor_task = bool(m.get("is_actor_task"))
            is_actor_creation = False
        actor_id_b = self.worker_actors.get(identity)

        # direct actor call that failed retriably: re-route using the spec
        # the worker shipped (no controller-side PendingTask exists)
        if m.get("error") is not None and t is None and m.get("retriable") \
                and m.get("spec") is not None:
            spec: TaskSpec = m["spec"]
            if spec.max_retries != 0:
                if spec.max_retries > 0:
                    spec.max_retries -= 1
                self._submit_actor_task(m.get("owner") or identity, spec)
                return

        # retry path (reference: TaskManager::RetryTaskIfPossible)
        if m.get("error") is not None and t is not None and t.retries_left > 0 \
                and m.get("retriable", False):
            t.retries_left -= 1
            if t.spec.is_actor_task:
                # actor tasks re-route to the actor's worker, never the
                # normal-task scheduler
                t.spec.max_retries = t.retries_left
                self._submit_actor_task(
                    self._find_owner_identity(t, m, identity) or identity,
                    t.spec)
                return
            if lease is None and t.node_id is not None:
                # leased tasks don't own resources (the lease does)
                self._release_res(t.node_id, self._sched_res(t.spec))
            t.node_id = None
            t.worker = None
            t.transfers_remaining.clear()
            self.tasks[tid] = t
            self._enqueue_ready(tid, t)
            if lease is not None:
                self._lease_housekeeping(identity, lease)
            elif not (is_actor_creation or actor_id_b):
                self._return_worker(identity)
            self._maybe_schedule()
            return

        # record results
        owner = (t.spec.owner.binary() if t and t.spec.owner else m.get("owner"))
        results_meta = []
        wake = []
        for r in m.get("results", []):
            if m.get("owner_notified") and r.get("inline") is None \
                    and not r.get("node_id") \
                    and (m.get("error") is None
                         or m.get("is_actor_task")):
                # owner-local result of a direct (actor) call: owner
                # holds it; nothing to record or forward, and any parked
                # borrower resolves via FETCH_OBJECT — not here. Actor
                # call ERRORS are owner-local too (their returns were
                # never promoted — recording would leak the entry);
                # controller-path task errors still record, because
                # their returns were promoted at submit and dep-parked
                # tasks fail fast off the entry.
                continue
            wake.append(r["object_id"])
            if self.refs.is_released(r["object_id"]):
                rb = r["object_id"]
                if self.local_waiters.get(rb) or self.dep_waiters.get(rb):
                    # the release was premature (delta batching can zero
                    # transiently while a waiter's +1 is still in
                    # flight): a waiter holds a live ref, so record the
                    # result and let the count resurrect
                    self.refs.cancel_release(rb)
                elif rb in self._pending_frees:
                    # zero still inside the free-grace window: record
                    # the result normally (keeping the tombstone); the
                    # deferred free — or a resurrecting +1 — decides
                    pass
                else:
                    # the owner already dropped every reference (its
                    # direct TASK_RESULT beat this TASK_DONE): recording
                    # the location would resurrect a dead entry and pin
                    # the extent forever — free it at the producing node
                    if r.get("node_id"):
                        node = self.nodes.get(r["node_id"])
                        if node is not None:
                            self._send(node.identity, P.FREE_OBJECT,
                                       {"object_id": rb})
                    continue
            if owner is not None and self.refs.is_dead(owner) \
                    and self.refs.count(ObjectID(r["object_id"])) <= 0 \
                    and not self.local_waiters.get(r["object_id"]) \
                    and not self.dep_waiters.get(r["object_id"]):
                # its owner died before this record and no live process
                # counts a ref to it (a borrower's +1 keeps it, as in
                # _release_dead_holder): free it at the producing node
                if r.get("node_id"):
                    node = self.nodes.get(r["node_id"])
                    if node is not None:
                        self._send(node.identity, P.FREE_OBJECT,
                                   {"object_id": r["object_id"]})
                continue
            e = self._entry(r["object_id"])
            e.owner = m.get("owner_identity", identity)
            self._set_owned_by(e, owner)
            e.size = r.get("size", 0)
            if r.get("inline") is not None:
                e.inline = r["inline"]
            if r.get("node_id"):
                e.locations.add(r["node_id"])
            if m.get("error") is not None and e.inline is None \
                    and not e.locations:
                # first-wins (duplicate executions; see above)
                e.error = m["error"]
            if t is not None and not t.spec.is_actor_creation:
                e.lineage_task = t.spec  # lineage for reconstruction
            results_meta.append({"object_id": r["object_id"],
                                 "inline": r.get("inline"),
                                 "node_id": r.get("node_id"),
                                 "size": r.get("size", 0),
                                 "error": m.get("error")})
        # resource release + worker return (actors hold their resources for
        # life; failed creations are released in _on_actor_created).
        # Leased workers: top up the pipeline from the class queue, close
        # the lease when both pipeline and queue drain.
        if lease is not None:
            self._lease_housekeeping(identity, lease)
        else:
            if t is not None and t.node_id is not None and not is_actor_task \
                    and not is_actor_creation:
                self._release_res(t.node_id, self._sched_res(t.spec))
            if not is_actor_creation and actor_id_b is None:
                self._return_worker(identity)

        # actor creation completion
        if is_actor_creation and t is not None:
            self._on_actor_created(t, identity, error=m.get("error"))

        # notify the owner so its memory store resolves the future — unless
        # the worker already pushed the result over the direct channel
        if not m.get("owner_notified"):
            owner_identity = self._find_owner_identity(t, m, identity)
            if owner_identity is not None:
                self._send(owner_identity, P.TASK_RESULT, {
                    "task_id": tid, "results": results_meta,
                    "error": m.get("error"),
                    # the controller recorded these results: the owner
                    # must promote owner-local returns to tracked
                    "via_controller": True})
        for b in wake:
            self._object_created(b)
        self._maybe_schedule()

    def _find_owner_identity(self, t: Optional[PendingTask], m: dict,
                             default: bytes) -> Optional[bytes]:
        # DEALER identities ARE binary worker ids in this design, so the
        # owner's WorkerID routes directly — no directory scan needed.
        if t is not None and t.spec.owner is not None:
            return t.spec.owner.binary()
        return m.get("owner")

    def _return_worker(self, identity: bytes) -> None:
        self._sched_dirty = True
        info = self.peers.get(identity)
        if not info:
            return
        node = self.nodes.get(info.get("node_id") or b"")
        if node is None or identity not in node.all_workers:
            return
        waiting = node.stats.get("wait_worker")
        if waiting:
            tid = waiting.popleft()
            if tid in self.tasks:
                self._dispatch_to_worker(tid, node, identity)
                return
        node.idle_workers.append(identity)
        self._grant_parked_leases()

    def _handle_task_failure(self, tid: bytes, reason: str,
                             retriable: bool = True,
                             release_resources: bool = True,
                             exc: Optional[BaseException] = None,
                             oom: bool = False) -> None:
        t = self.tasks.get(tid)
        if t is None:
            return
        if t.node_id is not None and release_resources and \
                t.worker not in self.leases:
            self._release_res(t.node_id, self._sched_res(t.spec))
        if oom:
            # OOM kills spend their own budget, with a delay so the node
            # can shed pressure before the task lands again — transient
            # spikes must not burn max_retries (reference: OOM retry
            # policy is separate, memory_monitor + task_manager)
            if t.oom_retries_left < 0:
                t.oom_retries_left = self.config.task_oom_retries
            if t.oom_retries_left > 0:
                t.oom_retries_left -= 1
                t.worker = None
                t.node_id = None
                t.transfers_remaining.clear()
                timer = threading.Timer(
                    self.config.oom_retry_delay_s,
                    lambda: self.call_on_loop(
                        lambda: self._requeue_after_oom(tid, t)))
                timer.daemon = True
                timer.start()
                return
        elif retriable and t.retries_left > 0:
            t.retries_left -= 1
            t.worker = None
            t.node_id = None
            t.transfers_remaining.clear()
            self._enqueue_ready(tid, t)
            self._maybe_schedule()
            return
        self.tasks.pop(tid, None)
        from ray_tpu_torch.exceptions import TaskError
        err = P.dumps(exc if exc is not None else
                      TaskError(t.spec.name or str(t.spec.function), reason))
        results_meta = []
        for oid in t.spec.return_ids():
            e = self._entry(oid.binary())
            e.error = err
            results_meta.append({"object_id": oid.binary(), "error": err})
            self._object_created(oid.binary())
        owner_identity = self._find_owner_identity(t, {}, b"")
        if owner_identity:
            self._send(owner_identity, P.TASK_RESULT, {
                "task_id": tid, "results": results_meta, "error": err,
                "via_controller": True})
        row = self.task_table.get(tid)
        if row is not None:
            row["state"] = "FAILED"

    def _reconstruct(self, e: ObjectEntry) -> None:
        """Lineage reconstruction: resubmit the creating task (reference:
        ObjectRecoveryManager::RecoverObject + TaskManager::ResubmitTask)."""
        spec = e.lineage_task
        if spec is None:
            return
        tid = spec.task_id.binary()
        if tid in self.tasks:
            return  # already being recomputed
        logger.info("reconstructing object %s via task %s",
                    e.object_id.hex()[:12], spec.task_id.hex()[:12])
        e.lineage_task = None  # avoid infinite loops; re-set on completion
        self._h_submit_task(e.owner or b"", {"spec": spec})

    def _h_cancel_task(self, identity: bytes, m: dict) -> None:
        tid = m["task_id"]
        t = self.tasks.get(tid)
        if t is None:
            return
        from ray_tpu_torch.exceptions import TaskCancelledError
        if t.state in ("PENDING_DEPS", "QUEUED", "PENDING_TRANSFER", "QUEUED_WORKER"):
            self.tasks.pop(tid, None)
            q = self.ready_queues.get(t.shape_key or ())
            if q is not None:
                try:
                    q.remove(tid)
                except ValueError:
                    pass
            if t.node_id is not None:
                self._release_res(t.node_id, self._sched_res(t.spec))
            err = P.dumps(TaskCancelledError(t.spec.task_id))
            results = []
            for oid in t.spec.return_ids():
                e = self._entry(oid.binary())
                e.error = err
                results.append({"object_id": oid.binary(), "error": err})
                self._object_created(oid.binary())
            owner_identity = self._find_owner_identity(t, {}, b"")
            if owner_identity:
                self._send(owner_identity, P.TASK_RESULT,
                           {"task_id": tid, "results": results,
                            "error": err, "via_controller": True})
        elif t.worker is not None:
            # dispatched: tell the worker to skip it if still queued
            # worker-side, or interrupt itself if it is the running task
            # (pipelined leases mean a blind SIGINT could hit a neighbour)
            self._send(t.worker, P.CANCEL_QUEUED,
                       {"task_id": tid, "force": m.get("force", False)})
            if m.get("force"):
                info = self.peers.get(t.worker, {})
                node = self.nodes.get(info.get("node_id") or b"")
                if node is not None:
                    self._send(node.identity, P.CANCEL_TASK, {
                        "pid": node.all_workers.get(t.worker, {}).get("pid"),
                        "force": True})

    # -------------------------------------------------------------- actors
    def _h_create_actor(self, identity: bytes, m: dict) -> None:
        spec: TaskSpec = m["spec"]
        aid = spec.actor_id.binary()
        info = ActorInfo(actor_id=spec.actor_id, spec=spec,
                         name=spec.actor_name, namespace=spec.namespace)
        if spec.actor_name:
            key = (spec.namespace, spec.actor_name)
            if key in self.named_actors:
                self._reply(identity, m["rid"],
                            {"error": f"actor name {spec.actor_name!r} taken"},
                            ok=False)
                return
            self.named_actors[key] = aid
            # named actors are durable: get_actor must resolve them after
            # a controller restart (their worker re-announces the binding)
            self.store.append(("actor", spec))
        self.actors[aid] = info
        self.actor_queues[aid] = collections.deque()
        self._reply(identity, m["rid"], {"ok": True})
        self._h_submit_task(identity, {"spec": spec})

    def _on_actor_created(self, t: PendingTask, worker: bytes,
                          error: Optional[bytes]) -> None:
        aid = t.spec.actor_id.binary()
        info = self.actors.get(aid)
        if info is None:
            return
        if error is not None:
            info.state = "DEAD"
            info.death_cause = "creation failed"
            self._fail_actor_queue(aid, error)
            self.worker_actors.pop(worker, None)
            self.actor_workers.pop(aid, None)
            self._return_worker(worker)
            if t.node_id is not None:
                self._release_res(t.node_id, self._sched_res(t.spec))
            self._publish(f"actor:{t.spec.actor_id.hex()}",
                          {"state": "DEAD", "actor_id": aid})
            self._answer_actor_addr_waiters(aid)
            return
        info.state = "ALIVE"
        if not t.spec.hold_resources and t.node_id is not None:
            # default-resource actor: scheduling CPU released once alive
            self._release_res(t.node_id, self._sched_res(t.spec))
        info.worker_id = WorkerID(worker) if len(worker) == WorkerID.SIZE else None
        self._publish(f"actor:{t.spec.actor_id.hex()}",
                      {"state": "ALIVE", "actor_id": aid})
        self._answer_actor_addr_waiters(aid)
        q = self.actor_queues.get(aid)
        while q:
            caller, spec = q.popleft()
            self._route_actor_task(caller, spec, worker)

    def _submit_actor_task(self, identity: bytes, spec: TaskSpec) -> None:
        aid = spec.actor_id.binary()
        info = self.actors.get(aid)
        if info is None or info.state == "DEAD":
            from ray_tpu_torch.exceptions import ActorDiedError
            err = P.dumps(ActorDiedError(spec.actor_id,
                                         info.death_cause if info else "unknown actor"))
            results = [{"object_id": oid.binary(), "error": err}
                       for oid in spec.return_ids()]
            self._send(identity, P.TASK_RESULT, {
                "task_id": spec.task_id.binary(), "results": results,
                "error": err, "via_controller": True})
            return
        worker = self.actor_workers.get(aid)
        if info.state != "ALIVE" or worker is None:
            self.actor_queues[aid].append((identity, spec))
            return
        self._route_actor_task(identity, spec, worker)

    def _route_actor_task(self, caller: bytes, spec: TaskSpec, worker: bytes) -> None:
        tid = spec.task_id.binary()
        self.tasks[tid] = PendingTask(spec=spec, state="RUNNING", worker=worker,
                                      retries_left=spec.max_retries)
        self.task_table[tid] = {
            "task_id": spec.task_id.hex(), "name": spec.name,
            "state": "RUNNING", "type": "ACTOR_TASK",
            "actor_id": spec.actor_id.hex(), "submitted_at": time.time()}
        inline_args = {}
        errors = {}
        for _, oid in spec.arg_refs:
            e = self.objects.get(oid.binary())
            if e is None:
                continue
            if e.error is not None:
                errors[oid.binary()] = e.error
            elif e.inline is not None:
                inline_args[oid.binary()] = e.inline
        self._send(worker, P.TASK_DISPATCH, {
            "spec": spec, "inline_args": inline_args, "arg_errors": errors})

    def _fail_actor_queue(self, aid: bytes, error: bytes) -> None:
        q = self.actor_queues.get(aid)
        while q:
            caller, spec = q.popleft()
            results = [{"object_id": oid.binary(), "error": error}
                       for oid in spec.return_ids()]
            self._send(caller, P.TASK_RESULT, {
                "task_id": spec.task_id.binary(), "results": results,
                "error": error, "via_controller": True})

    def _h_kill_actor(self, identity: bytes, m: dict) -> None:
        aid = m["actor_id"]
        info = self.actors.get(aid)
        if info is None:
            return
        no_restart = m.get("no_restart", True)
        worker = self.actor_workers.get(aid)
        if no_restart:
            info.spec.max_restarts = 0
        if worker is not None:
            winfo = self.peers.get(worker, {})
            node = self.nodes.get(winfo.get("node_id") or b"")
            if node is not None:
                self._send(node.identity, P.KILL_ACTOR, {
                    "pid": node.all_workers.get(worker, {}).get("pid")})

    def _h_actor_addr(self, identity: bytes, m: dict) -> None:
        """Address long-poll for the direct actor-call path: answer when the
        actor is ALIVE (its worker identity doubles as its direct-channel
        address), immediately if it is already dead."""
        aid = m["actor_id"]
        info = self.actors.get(aid)
        worker = self.actor_workers.get(aid)
        if info is None or info.state == "DEAD":
            from ray_tpu_torch.exceptions import ActorDiedError
            cause = info.death_cause if info else "unknown actor"
            self._reply(identity, m["rid"], {
                "dead": True,
                "error": P.dumps(ActorDiedError(ActorID(aid), cause))})
        elif info.state == "ALIVE" and worker is not None:
            self._reply(identity, m["rid"], {"worker": worker})
        else:
            self.actor_addr_waiters[aid].append((identity, m["rid"]))

    def _answer_actor_addr_waiters(self, aid: bytes) -> None:
        waiters = self.actor_addr_waiters.pop(aid, [])
        if not waiters:
            return
        info = self.actors.get(aid)
        worker = self.actor_workers.get(aid)
        if info is not None and info.state == "ALIVE" and worker is not None:
            for identity, rid in waiters:
                self._reply(identity, rid, {"worker": worker})
        elif info is None or info.state == "DEAD":
            from ray_tpu_torch.exceptions import ActorDiedError
            cause = info.death_cause if info else "unknown actor"
            blob = P.dumps(ActorDiedError(ActorID(aid), cause))
            for identity, rid in waiters:
                self._reply(identity, rid, {"dead": True, "error": blob})
        else:  # still pending (e.g. RESTARTING): keep waiting
            self.actor_addr_waiters[aid] = waiters

    def _h_get_actor(self, identity: bytes, m: dict) -> None:
        key = (m.get("namespace", ""), m["name"])
        aid = self.named_actors.get(key)
        if aid is None:
            self._reply(identity, m["rid"], {"error": "not found"}, ok=False)
        else:
            info = self.actors[aid]
            self._reply(identity, m["rid"], {
                "actor_id": aid, "spec_meta": {
                    "max_concurrency": info.spec.max_concurrency,
                    "is_async": info.spec.is_async_actor,
                    "module": info.spec.function.module,
                    "qualname": info.spec.function.qualname,
                }})

    # ------------------------------------------------- kv / functions / pg
    def _h_kv(self, identity: bytes, m: dict) -> None:
        ns, op = m.get("ns", ""), m["op"]
        table = self.kv[ns]
        if op == "put":
            overwrite = m.get("overwrite", True)
            if not overwrite and m["key"] in table:
                self._reply(identity, m["rid"], {"added": False})
                return
            table[m["key"]] = m["value"]
            self.store.append(("kv_put", ns, m["key"], m["value"]))
            self.store.maybe_compact(self._durable_state)
            self._reply(identity, m["rid"], {"added": True})
        elif op == "get":
            self._reply(identity, m["rid"], {"value": table.get(m["key"])})
        elif op == "del":
            existed = table.pop(m["key"], None) is not None
            if existed:
                self.store.append(("kv_del", ns, m["key"]))
            self._reply(identity, m["rid"], {"deleted": existed})
        elif op == "exists":
            self._reply(identity, m["rid"], {"exists": m["key"] in table})
        elif op == "keys":
            prefix = m.get("prefix", b"")
            self._reply(identity, m["rid"],
                        {"keys": [k for k in table if k.startswith(prefix)]})

    def _h_export_function(self, identity: bytes, m: dict) -> None:
        if m["key"] not in self.functions:
            self.store.append(("fn", m["key"], m["blob"]))
        self.functions[m["key"]] = m["blob"]
        if m.get("rid"):
            self._reply(identity, m["rid"], {"ok": True})

    def _h_fetch_function(self, identity: bytes, m: dict) -> None:
        self._reply(identity, m["rid"], {"blob": self.functions.get(m["key"])})

    def _h_create_pg(self, identity: bytes, m: dict) -> None:
        spec: PlacementGroupSpec = m["spec"]
        b = spec.pg_id.binary()
        self.pgs[b] = spec
        self.pg_creators[b] = identity
        if self.scheduler.reserve_placement_group(spec):
            self.pg_states[b] = "CREATED"
            self._reply(identity, m["rid"], {"state": "CREATED",
                                             "bundle_nodes": [bd.node_id.binary() for bd in spec.bundles],
                                             "bundle_labels": self.scheduler.bundle_labels(spec)})
        else:
            self.pg_states[b] = "PENDING"
            self.pending_pgs.append((identity, spec))
            self._reply(identity, m["rid"], {"state": "PENDING"})

    def _maybe_place_pgs(self) -> int:
        """Retry pending gang reservations; returns how many placed."""
        if not self.pending_pgs:
            return 0
        placed = 0
        still = collections.deque()
        while self.pending_pgs:
            identity, spec = self.pending_pgs.popleft()
            b = spec.pg_id.binary()
            if b not in self.pgs:
                continue
            if self.scheduler.reserve_placement_group(spec):
                self.pg_states[b] = "CREATED"
                placed += 1
                if identity:
                    self._send(identity, P.PG_UPDATE, {
                        "pg_id": b, "state": "CREATED",
                        "bundle_nodes": [bd.node_id.binary() for bd in spec.bundles],
                        "bundle_labels": self.scheduler.bundle_labels(spec)})
            else:
                still.append((identity, spec))
        self.pending_pgs = still
        return placed

    def _reschedule_pgs_on_nodes(self, node_bs) -> int:
        """Gang reservations touching these nodes (a dying host or a
        draining slice) are torn down atomically and re-queued: the
        group goes RESCHEDULING until fresh capacity — typically a new
        slice — admits every bundle again (reference: the GCS pg
        manager reschedules bundles on node death; slice drains reuse
        the same path). Returns how many groups were re-queued."""
        targets = set(node_bs)
        n = 0
        for b, spec in list(self.pgs.items()):
            if self.pg_states.get(b) != "CREATED":
                continue
            if not any(bd.node_id is not None
                       and bd.node_id.binary() in targets
                       for bd in spec.bundles):
                continue
            self.scheduler.release_placement_group(spec.pg_id)
            for bd in spec.bundles:
                bd.node_id = None
            self.pg_states[b] = "RESCHEDULING"
            creator = self.pg_creators.get(b, b"")
            self.pending_pgs.append((creator, spec))
            if creator:
                self._send(creator, P.PG_UPDATE,
                           {"pg_id": b, "state": "RESCHEDULING"})
            n += 1
        if n:
            self._sched_dirty = True
        return n

    def _h_remove_pg(self, identity: bytes, m: dict) -> None:
        b = m["pg_id"]
        self.pgs.pop(b, None)
        self.pg_creators.pop(b, None)
        self.pg_states[b] = "REMOVED"
        self.scheduler.release_placement_group(PlacementGroupID(b))
        self._sched_dirty = True  # freed bundle capacity
        self._reply(identity, m["rid"], {"ok": True})
        self._maybe_schedule()

    # ------------------------------------------------------ cluster health
    def _h_notify_blocked(self, identity: bytes, m: dict) -> None:
        """A worker's serial thread blocked in ray.get inside a task:
        release the lease's cpu so dependent work can run (reference:
        NotifyDirectCallTaskBlocked → raylet releases cpu resources)."""
        if identity in self.driver_leases:
            # direct driver-leased worker blocked in ray.get: free its
            # CPU so dependents can run (same contract as class leases)
            if identity not in self._lease_blocked:
                self._lease_blocked.add(identity)
                nb = self._lease_node.get(identity)
                if nb:
                    self._release_res(NodeID(nb), {"CPU": 1.0})
                self._maybe_schedule()
            return
        lease = self.leases.get(identity)
        if lease is None or lease.blocked:
            return
        lease.blocked = True
        node = self.nodes.get(lease.node_b)
        if node is not None and node.alive:
            self._release_res(NodeID(lease.node_b), lease.resources)
        self._maybe_schedule()

    def _h_notify_unblocked(self, identity: bytes, m: dict) -> None:
        if identity in self._blocked_orphans:
            # lease was reclaimed while this worker sat in ray.get; it
            # is now resumable — rejoin the pool (its CPU was already
            # released at block time and stays released until a new
            # dispatch acquires it)
            self._blocked_orphans.discard(identity)
            self._return_worker(identity)
            return
        if identity in self._lease_blocked:
            self._lease_blocked.discard(identity)
            nb = self._lease_node.get(identity)
            if nb:
                self.scheduler.force_acquire(NodeID(nb), {"CPU": 1.0})
            return
        lease = self.leases.get(identity)
        if lease is None or not lease.blocked:
            return
        lease.blocked = False
        # re-acquire, allowing transient oversubscription (the reference
        # resumes the task immediately too; availability self-corrects as
        # other tasks release)
        self.scheduler.force_acquire(NodeID(lease.node_b), lease.resources)
        self._lease_housekeeping(identity, lease)

    def _h_task_handback(self, identity: bytes, m: dict) -> None:
        """A blocking worker returned its unstarted pipeline tasks."""
        if m.get("blocked"):
            # the sender's serial thread is in ray.get RIGHT NOW: make
            # sure its lease is marked so refill stops targeting it
            # (idempotent; heals any missed NOTIFY_BLOCKED)
            lease = self.leases.get(identity)
            if lease is not None and not lease.blocked:
                lease.blocked = True
                node = self.nodes.get(lease.node_b)
                if node is not None and node.alive:
                    self._release_res(NodeID(lease.node_b),
                                      lease.resources)
            elif identity in self.driver_leases \
                    and identity not in self._lease_blocked:
                self._lease_blocked.add(identity)
                nb = self._lease_node.get(identity)
                if nb:
                    self._release_res(NodeID(nb), {"CPU": 1.0})
        requeued = False
        for spec in m.get("specs", ()):
            tid = spec.task_id.binary()
            t = self.tasks.get(tid)
            if t is None:
                if tid not in self.task_table:
                    # direct dispatch bounced by a blocked worker (the
                    # lease may already be reclaimed — adopt anyway; a
                    # handed-back spec vanishing strands its owner)
                    self._h_submit_task(
                        spec.owner.binary() if spec.owner else identity,
                        {"spec": spec})
                    requeued = True
                continue
            if t.worker != identity or t.state != "RUNNING":
                continue
            lease = self.leases.get(identity)
            if lease is not None:
                lease.inflight.discard(tid)
            t.worker = None
            t.node_id = None
            self._enqueue_ready(tid, t)
            requeued = True
        if requeued:
            self._maybe_schedule()

    def _h_ping(self, identity: bytes, m: dict) -> None:
        info = self.peers.get(identity)
        if info is not None:
            info["last_seen"] = time.monotonic()

    def _h_heartbeat(self, identity: bytes, m: dict) -> None:
        node = self.nodes.get(m["node_id"])
        if node is not None:
            node.last_heartbeat = time.monotonic()
            node.stats.update(m.get("stats") or {})

    def _h_worker_exit(self, identity: bytes, m: dict) -> None:
        """Node manager reports a worker process died."""
        worker_identity = m.get("worker_identity")
        if worker_identity and self._reliable is not None:
            # peer-death notice: the task failover below is the
            # recovery — abandon retransmits into the dead worker
            self._reliable.drop_target(worker_identity)
        node = self.nodes.get(m.get("node_id") or b"")
        if node is not None and worker_identity in node.all_workers:
            del node.all_workers[worker_identity]
            self._worker_env.pop(worker_identity, None)
            self._gpu_workers.discard(worker_identity)
            driver = self.driver_leases.pop(worker_identity, None)
            self._blocked_orphans.discard(worker_identity)
            if driver is not None:
                nb = self._lease_node.pop(worker_identity, None)
                if nb and worker_identity not in self._lease_blocked:
                    self._release_res(NodeID(nb), {"CPU": 1.0})
                self._lease_blocked.discard(worker_identity)
                # the lease owner must resubmit in-flight direct tasks
                self._send(driver, P.LEASE_REVOKED,
                           {"worker": worker_identity, "dead": True})
            try:
                node.idle_workers.remove(worker_identity)
            except ValueError:
                pass
        elif node is not None and m.get("requested"):
            # a worker WE requested died before registering: it was still
            # counted as starting — without this, waiting tasks never get
            # a replacement (node-initiated initial workers were never
            # counted, so those must not decrement)
            node.starting_workers = max(0, node.starting_workers - 1)
        self.peers.pop(worker_identity, None)
        if worker_identity:
            self._release_dead_holder(worker_identity)
        aid = self.worker_actors.pop(worker_identity, None)
        # close any lease first: its single resource allocation is released
        # here, so per-task failure handling must not release again
        lease = self.leases.pop(worker_identity, None)
        if lease is not None:
            peers_set = self.class_leases.get(lease.shape_key)
            if peers_set is not None:
                peers_set.discard(worker_identity)
            lnode = self.nodes.get(lease.node_b)
            if lnode is not None and lnode.alive and not lease.blocked:
                self._release_res(NodeID(lease.node_b), lease.resources)
        # fail/retry every in-flight task dispatched to that worker
        oom = m.get("reason") == "oom"
        for tid, t in list(self.tasks.items()):
            if t.worker != worker_identity:
                continue
            if t.spec.is_actor_task:
                self._on_actor_worker_died(worker_identity, tid)
            elif t.spec.is_actor_creation:
                # actor restart path owns resubmission (below)
                self.tasks.pop(tid, None)
            elif oom:
                # memory-monitor kill: retries from the OOM budget with
                # backoff, surfacing OutOfMemoryError once exhausted
                from ray_tpu_torch.exceptions import OutOfMemoryError
                self._handle_task_failure(
                    tid, "worker killed by the node memory monitor",
                    release_resources=lease is None, oom=True,
                    exc=OutOfMemoryError(
                        f"task {t.spec.name or ''} was killed by the node "
                        f"memory monitor: node memory usage exceeded "
                        f"{self.config.memory_usage_threshold:.0%}"))
            else:
                self._handle_task_failure(tid, "worker died during execution",
                                          release_resources=lease is None)
        if aid is not None:
            self._on_actor_died(aid, worker_identity)
        # tasks already queued for a worker on this node must not strand:
        # the dead worker can't serve them and nothing else re-requests
        # a replacement (common under the OOM killer)
        if node is not None and node.alive:
            waiting = node.stats.get("wait_worker")
            if waiting and not node.idle_workers \
                    and node.starting_workers < len(waiting):
                node.starting_workers += 1
                self._send(node.identity, P.TASK_ASSIGN,
                           {"start_worker": True})
        self._maybe_schedule()

    def _on_actor_worker_died(self, worker_identity: bytes, tid: bytes) -> None:
        t = self.tasks.pop(tid, None)
        if t is None:
            return
        from ray_tpu_torch.exceptions import ActorDiedError, ActorUnavailableError
        info = self.actors.get(t.spec.actor_id.binary())
        will_restart = info is not None and info.state != "DEAD" and (
            info.spec.max_restarts < 0
            or info.num_restarts < info.spec.max_restarts)
        if will_restart:
            # the actor is coming back: the racing call is unavailable,
            # not dead — callers holding the handle may retry
            err = P.dumps(ActorUnavailableError(
                t.spec.actor_id, "actor worker died mid-call; the actor "
                "is restarting"))
        else:
            err = P.dumps(ActorDiedError(t.spec.actor_id, "worker died"))
        results = [{"object_id": oid.binary(), "error": err}
                   for oid in t.spec.return_ids()]
        owner_identity = self._find_owner_identity(t, {}, b"")
        if owner_identity:
            self._send(owner_identity, P.TASK_RESULT, {
                "task_id": tid, "results": results, "error": err,
                "via_controller": True})

    def _on_actor_died(self, aid: bytes, worker_identity: bytes) -> None:
        """Actor restart state machine (reference: gcs_actor_manager.h
        :249-281)."""
        info = self.actors.get(aid)
        if info is None:
            return
        self.actor_workers.pop(aid, None)
        if info.node_id is not None and info.spec.hold_resources:
            self._release_res(info.node_id, self._sched_res(info.spec))
        if info.num_restarts < info.spec.max_restarts or info.spec.max_restarts < 0:
            info.num_restarts += 1
            info.state = "RESTARTING"
            self._publish(f"actor:{info.actor_id.hex()}",
                          {"state": "RESTARTING", "actor_id": aid})
            self._h_submit_task(b"", {"spec": info.spec})
        else:
            info.state = "DEAD"
            info.death_cause = "worker process died"
            self._publish(f"actor:{info.actor_id.hex()}",
                          {"state": "DEAD", "actor_id": aid})
            self._answer_actor_addr_waiters(aid)
            from ray_tpu_torch.exceptions import ActorDiedError
            err = P.dumps(ActorDiedError(info.actor_id, info.death_cause))
            self._fail_actor_queue(aid, err)
            if info.name:
                self.named_actors.pop((info.namespace, info.name), None)
                self.store.append(("actor_dead", aid))

    def _health_loop(self) -> None:
        cfg = self.config
        period = cfg.health_check_period_ms / 1000.0
        threshold = cfg.health_check_failure_threshold * period + \
            cfg.health_check_timeout_ms / 1000.0
        while not self._shutdown.wait(period):
            now = time.monotonic()
            # self-healing backstops: a missed dirty-mark or a stranded
            # dep-parked task can only delay work by one period
            try:
                self.call_on_loop(lambda: self._maybe_schedule(force=True))
                self.call_on_loop(self._audit_parked_tasks)
                self.call_on_loop(self._audit_parked_waiters)
                self.call_on_loop(self._audit_driver_leases)
                self.call_on_loop(self._drain_pending_frees)
            except Exception:
                pass
            try:
                from ray_tpu_torch.core.metric_defs import update_from_state
                update_from_state(controller=self)
            except Exception:
                pass
            # the controller's own registry joins the fleet plane
            # through the same reporter path every other process uses
            try:
                self.metrics_reporter.maybe_report()
            except Exception:
                pass
            for node in list(self.nodes.values()):
                if node.alive and node.last_heartbeat and \
                        now - node.last_heartbeat > threshold:
                    self._on_node_dead(node)
            # recovered named actors whose workers never re-announced
            # within the grace window died during the controller's
            # downtime: run the normal death/restart state machine so
            # get_actor waiters aren't parked forever
            if self._recovered_actors and \
                    now - self._started_at > max(15.0, threshold):
                stale = list(self._recovered_actors)
                self._recovered_actors.clear()
                for aid in stale:
                    try:
                        self.call_on_loop(
                            lambda a=aid: self._expire_recovered_actor(a))
                    except Exception:
                        logger.exception("recovered-actor expiry failed")

    def _audit_parked_tasks(self) -> None:
        """Backstop against stranded PENDING_DEPS tasks: a task whose dep
        arrived without a wake resumes; one whose dep is reconstructable
        reconstructs; one whose dep is gone for good fails loudly with
        ObjectLostError instead of hanging forever."""
        now = time.monotonic()
        for tid, t in list(self.tasks.items()):
            if t.state != "PENDING_DEPS" or not t.deps_remaining:
                continue
            # healthy producers are excluded via _object_expected below,
            # so a moderate age gate suffices (repairing a real
            # directory hole within ~15s instead of minutes)
            if now - (t.submitted_at or now) < 15.0:
                continue
            for b in list(t.deps_remaining):
                e = self.objects.get(b)
                if e is not None and (e.inline is not None
                                      or e.error is not None
                                      or e.locations):
                    # dep exists but the wake was missed
                    self._object_created(b)
                elif e is not None and e.lineage_task is not None:
                    self._reconstruct(e)
                elif e is None:
                    if self._object_expected(b):
                        # the producing task is tracked and alive: this
                        # is a healthy dependency wait, not a hole
                        t._audit_strikes = 0
                        continue
                    # strike 1: probe node stores — a producer killed
                    # between storing the object and reporting it leaves
                    # the bytes resident with no directory entry; the
                    # node re-announces and the task resumes.
                    # many strikes later: genuinely gone — fail loudly.
                    strikes = getattr(t, "_audit_strikes", 0) + 1
                    t._audit_strikes = strikes
                    if strikes in (1, 5, 30):
                        self._probe_nodes_for(b)
                        continue
                    if strikes < 300:
                        continue
                    self.dep_waiters.pop(b, None)
                    from ray_tpu_torch.exceptions import ObjectLostError
                    self._handle_task_failure(
                        tid, f"dependency {ObjectID(b).hex()[:12]} was "
                        f"freed or lost before the task could run",
                        retriable=False,
                        exc=ObjectLostError(
                            ObjectID(b), "freed before dependent task "
                            "could run"))
                    break

    def _probe_nodes_for(self, object_id_b: bytes) -> None:
        for node in self.nodes.values():
            if node.alive:
                self._send(node.identity, P.LOCATE_OBJECT,
                           {"object_id": object_id_b})

    def _object_expected(self, object_id_b: bytes) -> bool:
        """True if a tracked pending/running task will produce this
        object — waiters on it are healthy, not stranded."""
        try:
            tid = ObjectID(object_id_b).task_id().binary()
        except Exception:
            return False
        return tid in self.tasks

    def _audit_parked_waiters(self) -> None:
        """Backstop for gets parked on objects the directory never
        learned about (producer killed between store and report): probe
        node stores after a minute, fail with ObjectLostError if the
        probes come back empty. Also drops waiters whose client is
        gone."""
        now = time.monotonic()
        for b in list(self._waiter_since):
            waiters = self.local_waiters.get(b)
            if not waiters or self.objects.get(b) is not None:
                self._waiter_since.pop(b, None)
                self._hole_strikes.pop(b, None)
                continue
            live = [(ident, rid) for ident, rid in waiters
                    if ident in self.peers]
            if not live:
                self.local_waiters.pop(b, None)
                self._waiter_since.pop(b, None)
                self._hole_strikes.pop(b, None)
                continue
            self.local_waiters[b] = live
            owner_b = self._owner_fetches.get(b)
            if owner_b is not None and owner_b not in self.peers:
                # waiting on an owner-local object whose owner is gone:
                # nothing can ever publish it — fail fast (reference:
                # OwnerDiedError semantics for in-process-store objects)
                from ray_tpu_torch.exceptions import ObjectLostError
                err = P.dumps(ObjectLostError(
                    ObjectID(b), "the object's owner died before "
                    "publishing this owner-local object"))
                for ident, rid in self.local_waiters.pop(b, []):
                    self._reply(ident, rid, {"error": err})
                self._owner_fetches.pop(b, None)
                self._waiter_since.pop(b, None)
                self._hole_strikes.pop(b, None)
                continue
            if now - self._waiter_since[b] < 15.0:
                continue
            if self._object_expected(b):
                # the producing task is tracked and alive — healthy wait
                self._hole_strikes.pop(b, None)
                continue
            strikes = self._hole_strikes.get(b, 0) + 1
            self._hole_strikes[b] = strikes
            if owner_b is not None and strikes in (1, 5, 30):
                # re-ask a live owner (the first FETCH_OBJECT may have
                # been dropped in a reconnect window)
                self._send(owner_b, P.FETCH_OBJECT, {"object_id": b})
            if strikes in (1, 5, 30):
                # cheap repair probes; directory holes (producer killed
                # between store and report) resolve on the first one
                self._probe_nodes_for(b)
            elif strikes >= 300:
                # ~5 minutes with no probe hit and no tracked producer:
                # give up loudly instead of hanging the get forever
                from ray_tpu_torch.exceptions import ObjectLostError
                err = P.dumps(ObjectLostError(
                    ObjectID(b), "no node store holds this object"))
                for ident, rid in self.local_waiters.pop(b, []):
                    self._reply(ident, rid, {"error": err})
                self._waiter_since.pop(b, None)
                self._hole_strikes.pop(b, None)

    def _requeue_after_oom(self, tid: bytes, t: PendingTask) -> None:
        if self.tasks.get(tid) is not t:
            return  # cancelled/failed while the backoff timer ran
        self._enqueue_ready(tid, t)
        self._maybe_schedule()

    def _expire_recovered_actor(self, aid: bytes) -> None:
        info = self.actors.get(aid)
        if info is not None and info.state == "RESTARTING":
            logger.warning(
                "recovered actor %s never re-announced; declaring its "
                "worker dead", ActorID(aid).hex()[:12])
            self._on_actor_died(aid, b"")

    def _on_node_dead(self, node: NodeInfo) -> None:
        logger.warning("node %s declared dead", node.node_id.hex()[:12])
        if self._reliable is not None:
            self._reliable.drop_target(node.identity)
        node.alive = False
        node.resources.alive = False
        self.scheduler.remove_node(node.node_id)
        self._publish("node", {"event": "removed",
                               "node_id": node.node_id.binary()})
        node_b = node.node_id.binary()
        # prune object locations; lost objects get lazily reconstructed
        for e in self.objects.values():
            e.locations.discard(node_b)
        # fail/retry tasks running there
        for worker_identity in list(node.all_workers):
            self._h_worker_exit(node.identity, {
                "worker_identity": worker_identity, "node_id": node_b})
        # gang reservations that spanned this host reschedule as a unit
        # (a preempted slice host strands its whole placement group)
        if self._reschedule_pgs_on_nodes({node_b}):
            self._maybe_schedule()

    # -------------------------------------------------------- observability
    def _h_state_query(self, identity: bytes, m: dict) -> None:
        self._reply(identity, m["rid"], {
            "rows": self.state_rows(m["what"], m.get("limit"),
                                    m.get("params"))})

    def state_rows(self, what: str, limit: Optional[int] = None,
                   params: Optional[dict] = None):
        """Loop-thread-only state snapshot (shared by the wire state
        API and the dashboard head, which holds a direct reference).
        The ``metrics*`` views only touch the internally-locked
        MetricsPlane, so they are safe from any thread."""
        if what == "metrics":
            return self.metrics_plane.catalog()
        if what == "metrics_query":
            p = params or {}
            return self.metrics_plane.query(
                p.get("name", ""),
                window_s=float(p.get("window_s", 60.0)),
                agg=p.get("agg"))
        if what == "metrics_fleet":
            p = params or {}
            return self.metrics_plane.fleet_summary(
                window_s=float(p.get("window_s", 30.0)))
        if what == "metrics_latest":
            return self.metrics_plane.latest_samples(
                (params or {}).get("name", ""))
        # request-trace views only touch the internally-locked
        # RequestTraceStore — safe from any thread, like metrics*.
        if what == "requests":
            return self.request_traces.rows(limit=limit or 50)
        if what == "request_trace":
            w = self.request_traces.waterfall(
                (params or {}).get("request_id", ""))
            return [w] if w is not None else []
        m = {"limit": limit} if limit else {}
        if what == "nodes":
            rows = [{
                "node_id": n.node_id.hex(), "alive": n.alive,
                "resources_total": n.resources.total,
                "resources_available": n.resources.available,
                "labels": dict(n.resources.labels),
                "num_workers": len(n.all_workers), "stats": dict(n.stats, wait_worker=None),
            } for n in self.nodes.values()]
        elif what == "node_processes":
            # per-node-agent process stats (reference: the reporter
            # agent's per-process psutil feed, flattened per worker)
            rows = []
            for n in self.nodes.values():
                if not n.alive:
                    continue
                for p in n.stats.get("processes") or []:
                    rows.append(dict(p, node_id=n.node_id.hex()))
        elif what == "tasks":
            rows = list(self.task_table.values())[-m.get("limit", 1000):]
        elif what == "actors":
            rows = [{
                "actor_id": a.actor_id.hex(), "state": a.state,
                "name": a.name, "namespace": a.namespace,
                "num_restarts": a.num_restarts,
                "node_id": a.node_id.hex() if a.node_id else None,
            } for a in self.actors.values()]
        elif what == "objects":
            rows = [{
                "object_id": e.object_id.hex(), "size": e.size,
                "inline": e.inline is not None,
                "locations": [l.hex()[:12] for l in e.locations],
                "has_error": e.error is not None,
            } for e in list(self.objects.values())[:m.get("limit", 1000)]]
        elif what == "placement_groups":
            rows = [{
                "pg_id": PlacementGroupID(b).hex(), "state": self.pg_states.get(b),
                "strategy": spec.strategy, "name": spec.name,
                "bundles": [bd.resources for bd in spec.bundles],
                "bundle_nodes": [bd.node_id.hex() if bd.node_id else None
                                 for bd in spec.bundles],
                "bundle_labels": self.scheduler.bundle_labels(spec),
            } for b, spec in self.pgs.items()]
        elif what == "jobs":
            rows = list(self.jobs.values())
        elif what == "cluster_resources":
            rows = self.scheduler.cluster_resources()
        elif what == "available_resources":
            rows = self.scheduler.available_resources()
        elif what == "timeline":
            rows = self.task_events[-m.get("limit", 100_000):]
        elif what == "task_events":
            # merged flight-recorder stream: pull the controller's own
            # buffered events in first so the snapshot is fresh
            self.recorder.flush()
            with self._events_lock:
                rows = self.flight_events[-m.get("limit", 100_000):]
        else:
            rows = []
        return rows

    # -------------------------------------------------- worker profiling
    def profile_worker(self, worker_identity_b: bytes,
                       duration_s: float = 2.0,
                       timeout_s: float = 30.0) -> Optional[dict]:
        """Ask a worker to sample its own stacks and return the
        collapsed-stack flamegraph artifact (reference: the dashboard's
        on-demand py-spy via profile_manager.py:79; here the worker's
        in-process sampler, which needs no external tooling). Called
        from the dashboard's HTTP threads."""
        import os as _os
        rid = _os.urandom(8)
        ev = threading.Event()
        slot: dict = {}
        self._profile_waiters[rid] = (ev, slot)
        def send_if_known():
            if worker_identity_b not in self.peers:
                # a spawned-but-unregistered worker can't be reached by
                # identity; fail fast instead of timing out
                return False
            self._send(worker_identity_b, P.PROFILE_SELF,
                       {"rid": rid, "duration_s": duration_s})
            return True

        try:
            if not self.call_on_loop(send_if_known):
                return {"error": "worker is not registered "
                        "(still booting, or gone)"}
            if not ev.wait(timeout_s):
                return None
            return slot.get("data")
        finally:
            self._profile_waiters.pop(rid, None)

    def _h_profile_result(self, identity: bytes, m: dict) -> None:
        ent = self._profile_waiters.get(m.get("rid") or b"")
        if ent is not None:
            ent[1]["data"] = m
            ent[0].set()

    def _h_timeline(self, identity: bytes, m: dict) -> None:
        self.task_events.extend(m["events"])
        cap = self.config.task_events_max_buffer
        if len(self.task_events) > cap:
            self.task_events = self.task_events[-cap:]

    def _ingest_events(self, events: List[dict]) -> None:
        """Append flight-recorder events into the bounded aggregation
        buffer (thread-safe: remote TEV batches land on the loop
        thread, the controller's own watermark flushes can fire from
        the reliable layer's thread)."""
        with self._events_lock:
            self.flight_events.extend(events)
            cap = self.config.task_events_max_buffer
            if len(self.flight_events) > cap:
                del self.flight_events[:len(self.flight_events) - cap]

    def _h_task_events(self, identity: bytes, m: dict) -> None:
        self._ingest_events(m.get("events") or [])

    def _h_metric_report(self, identity: bytes, m: dict) -> None:
        """Fleet metrics plane ingest: merge one process's periodic
        snapshot (seq-guarded — exactly-once-effect even past the
        reliable layer's dedup window)."""
        self.metrics_plane.ingest(m)

    def _h_request_spans(self, identity: bytes, m: dict) -> None:
        """Per-request trace ingest: one tail-sampled span batch.
        (request_id, part, seq)-deduped in the store, so a retransmit
        or chaos dup never doubles a waterfall."""
        self.request_traces.ingest(m)

    def _h_subscribe(self, identity: bytes, m: dict) -> None:
        self.subs[m["channel"]].add(identity)

    def _h_pubsub(self, identity: bytes, m: dict) -> None:
        self._publish(m["channel"], m["data"])

    def _publish(self, channel: str, data: Any) -> None:
        for identity in self.subs.get(channel, ()):
            self._send(identity, P.PUBSUB, {"channel": channel, "data": data})
        for identity in self.subs.get("*", ()):
            self._send(identity, P.PUBSUB, {"channel": channel, "data": data})

    def _h_msg_ack(self, identity: bytes, m: dict) -> None:
        if self._reliable is not None:
            self._reliable.on_ack(m)

    def _h_shutdown(self, identity: bytes, m: dict) -> None:
        for node in self.nodes.values():
            self._send(node.identity, P.SHUTDOWN, {})
        self._shutdown.set()

    _HANDLERS = {
        P.REGISTER: _h_register,
        P.SUBMIT_TASK: _h_submit_task,
        P.SUBMIT_BATCH: _h_submit_batch,
        P.TASK_DONE: _h_task_done,
        P.CANCEL_TASK: _h_cancel_task,
        P.CREATE_ACTOR: _h_create_actor,
        P.KILL_ACTOR: _h_kill_actor,
        P.GET_ACTOR: _h_get_actor,
        P.ACTOR_ADDR: _h_actor_addr,
        P.PUT_OBJECT: _h_put_object,
        P.GET_LOCATION: _h_get_location,
        P.PULL_FAILED: _h_pull_failed,
        P.REF_DELTAS: _h_ref_deltas,
        P.OWNER_FREE: _h_owner_free,
        P.LEASE_WORKERS: _h_lease_workers,
        P.RELEASE_LEASES: _h_release_leases,
        P.KV_OP: _h_kv,
        P.EXPORT_FUNCTION: _h_export_function,
        P.FETCH_FUNCTION: _h_fetch_function,
        P.CREATE_PG: _h_create_pg,
        P.REMOVE_PG: _h_remove_pg,
        P.HEARTBEAT: _h_heartbeat,
        P.PROFILE_RESULT: _h_profile_result,
        P.PING: _h_ping,
        P.WORKER_EXIT: _h_worker_exit,
        P.NOTIFY_BLOCKED: _h_notify_blocked,
        P.NOTIFY_UNBLOCKED: _h_notify_unblocked,
        P.TASK_HANDBACK: _h_task_handback,
        P.STATE_QUERY: _h_state_query,
        P.TIMELINE_EVENTS: _h_timeline,
        P.TASK_EVENTS: _h_task_events,
        P.METRIC_REPORT: _h_metric_report,
        P.REQUEST_SPANS: _h_request_spans,
        P.SUBSCRIBE: _h_subscribe,
        P.PUBSUB: _h_pubsub,
        P.MSG_ACK: _h_msg_ack,
        P.SHUTDOWN: _h_shutdown,
    }
