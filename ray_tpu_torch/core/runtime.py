"""Per-process runtime: the core-worker library.

Equivalent of the reference's ``CoreWorker`` (``src/ray/core_worker/
core_worker.h``; Cython surface ``python/ray/_raylet.pyx:3177``): lives in
every driver and worker process; provides submit_task / create_actor /
submit_actor_task / get / put / wait / cancel, owns the in-process memory
store, the reference counter, and the serialization context. A background
pump thread owns the DEALER socket (all control traffic); synchronous RPCs
are correlated via ReplyWaiter.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import collections
from collections import OrderedDict
from queue import Empty, SimpleQueue

import zmq

from ray_tpu_torch.core import chaos as CH
from ray_tpu_torch.core import direct as D
from ray_tpu_torch.core import events as EV
from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core import reliable as RD
from ray_tpu_torch.core.config import Config, get_config
from ray_tpu_torch.core.ids import (
    ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID)
from ray_tpu_torch.core.memory_store import InProcessStore, fresh_error
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.reference_counter import ReferenceCounter
from ray_tpu_torch.core.serialization import (
    SerializationContext, SerializedObject, holds_tensors)
from ray_tpu_torch.exceptions import ObjectStoreFullError
from ray_tpu_torch.core.shm_store import make_client
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.exceptions import GetTimeoutError

logger = logging.getLogger(__name__)


#: flusher-queue target marker for deferrable controller messages
_DEFER = object()


class _ArgPlaceholder:
    """Marks a positional arg that was a top-level ObjectRef."""
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_ArgPlaceholder, (self.index,))


class Runtime:
    def __init__(self, kind: str, session_dir: str, node_id: NodeID,
                 worker_id: Optional[WorkerID] = None,
                 shm_session: Optional[str] = None):
        self.kind = kind
        self.session_dir = session_dir
        self.node_id = node_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.job_id = JobID.from_int(0)
        self.config: Config = get_config()

        # flight recorder (core/events.py): bounded per-process event
        # ring, flushed to the controller as TASK_EVENTS. Created
        # before the reliable layer so transport events are captured
        # from the first message.
        self.recorder = EV.make_recorder(
            f"{kind}:{self.worker_id.hex()[:12]}", self.config,
            send=self._send_events)

        # seeded fault injection (chaos.py): None in production — every
        # hook below is a single attribute check when disabled
        self._chaos = CH.maybe_injector(kind,
                                        self_id=self.worker_id.binary())
        self._chaos_dedup = CH.SeqDeduper() if self._chaos is not None \
            else None
        # lease/reconnect retry backoff: exponential with full jitter
        # (replaces the old fixed 2.0s sleeps — under chaos every driver
        # retrying in lockstep hammered the restarted controller)
        from ray_tpu_torch.util.backoff import ExponentialBackoff
        _bo_rng = self._chaos.rng_for("lease-backoff") \
            if self._chaos is not None else None
        self._lease_backoff = ExponentialBackoff(
            base=self.config.lease_backoff_base_s,
            cap=self.config.lease_backoff_cap_s, rng=_bo_rng)
        self._topup_backoff = ExponentialBackoff(
            base=self.config.lease_backoff_base_s,
            cap=self.config.lease_backoff_cap_s, rng=_bo_rng)
        # reliable-delivery sublayer (core/reliable.py): critical one-way
        # messages get ack/retransmit; retransmit duplicates are deduped
        # receiver-side. Resends re-enter the flusher queue (thread-safe)
        # and pass the chaos filter again like any first transmission.
        self._reliable = RD.maybe_transport(
            self.config, self._reliable_resend, self._reliable_ack,
            rng=self._chaos.rng_for("retransmit")
            if self._chaos is not None else None, name=kind,
            recorder=self.recorder)

        # fleet metrics reporter (util/metrics.py): periodic full-
        # registry snapshots to the controller's metrics plane as
        # METRIC_REPORT — fire-and-forget like the flight recorder,
        # with superseded in-flight reports abandoned from the
        # reliable ring (drop-oldest, counted) so a dead link never
        # grows a backlog.
        from ray_tpu_torch.util import metrics as MX
        self.metrics_reporter = MX.make_reporter(
            self._send_metric_report,
            {"node": node_id.hex()[:12], "pid": os.getpid(),
             "role": kind},
            self.config,
            pending_drop=(
                (lambda keep: self._reliable.drop_oldest_of(
                    P.METRIC_REPORT, keep))
                if self._reliable is not None else None))

        self.memory_store = InProcessStore()
        self.reference_counter = ReferenceCounter(self._flush_ref_deltas)
        self.reference_counter.set_owner_zero_fn(self._on_owner_zero)
        self.serialization = SerializationContext(self)
        self.shm = make_client(shm_session) if shm_session else None
        self.shm_session = shm_session

        # Eager owner-side recycling (reference: owner-based GC frees an
        # object the moment its owner's counts hit zero). put() objects
        # whose refs never leave this process are evicted directly from
        # the shared segment on last-ref-drop — the extent returns to the
        # allocator freelist with its pages still resident, so a hot
        # put loop recycles warm extents instead of faulting fresh ones.
        self._eager_owned: Dict[bytes, None] = {}
        self._escaped_refs: "OrderedDict[bytes, None]" = OrderedDict()
        self._eager_lock = threading.Lock()
        self._empty_args_blob: Optional[bytes] = None

        # Owner-local small objects (reference: the in-process store +
        # owner-based object directory — the GCS never hears about
        # small objects). Inline puts and task returns stay out of the
        # controller's directory/refcount tables until a ref ESCAPES
        # (pickled or passed as a task arg), at which point the object
        # is promoted and its value published. Guarded by _meta_lock.
        self._owner_local = bool(
            getattr(self.config, "owner_local_objects", False))
        #: owner-local oids whose meta/value live only in this process
        self._local_objects: Dict[bytes, None] = {}
        #: oids to publish to the controller the moment their result
        #: arrives (escaped-while-pending, or a borrower FETCH_OBJECT)
        self._publish_on_result: Dict[bytes, None] = {}

        # Direct normal-task transport (reference: worker leases,
        # direct_task_transport.h): the driver leases workers from the
        # controller and pushes dependency-free default-shape tasks to
        # them peer-to-peer; only TASK_DONE accounting reaches the
        # controller. State guarded by _lease_lock.
        self._lease_lock = threading.Lock()
        self._lease_pool: List[bytes] = []
        self._lease_inflight: Dict[bytes, int] = {}
        self._lease_state = "none"      # none | pending | ready
        self._lease_backoff_until = 0.0
        self._direct_tids: Dict[bytes, bytes] = {}  # tid -> worker
        # saturated-lease overflow queues HERE and drains on completions
        # (falling back to the controller would starve its queue behind
        # lease-held CPUs and trigger reclaim thrash)
        self._direct_backlog: Deque[TaskSpec] = collections.deque()
        #: memory bound on locally-queued direct tasks — NOT a
        #: throughput valve (the controller path is slower per task).
        #: Both a count cap and a byte cap: specs carry the full inline
        #: args blob, so count alone bounds nothing when tasks pass
        #: megabyte args by value.
        self._direct_backlog_cap = int(os.environ.get(
            "RAY_TPU_TORCH_DIRECT_BACKLOG_CAP", "200000"))
        self._direct_backlog_bytes_cap = int(os.environ.get(
            "RAY_TPU_TORCH_DIRECT_BACKLOG_BYTES_CAP", str(1 << 31)))  # 2 GiB
        self._direct_backlog_bytes = 0
        #: a LEASE_WORKERS request is outstanding (initial or top-up)
        self._lease_req_inflight = False
        #: after an empty top-up grant (cluster fully leased — usually by
        #: us), don't re-ask until this deadline: each empty round trip
        #: costs a controller hop and grants nothing
        self._lease_topup_backoff = 0.0

        # object_id(bytes) -> result meta {"inline"|"node_id"/"size"|"error"}
        self._meta: Dict[bytes, dict] = {}
        self._meta_lock = threading.Lock()
        #: streaming generator tasks we own (task_id bytes -> StreamState);
        #: entries are routing state only — dropped at close / terminal
        #: failure / full consumption (core/streaming.py)
        self._streams: Dict[bytes, Any] = {}
        self._streams_lock = threading.Lock()
        #: worker-side hook (WorkerExecutor): STREAM_CREDIT consumption
        #: reports for generator tasks executing in this process
        self.stream_credit_handler: Optional[Callable[[dict], None]] = None
        self._completion_cbs: Dict[bytes, List[Callable]] = {}
        self._pending_locations: Dict[bytes, float] = {}  # object -> probe ts

        self.replies = P.ReplyWaiter()
        self._put_counter = 0
        self._task_counter = 0
        self._lock = threading.Lock()
        self._driver_task_id = TaskID.for_driver(self.job_id)
        # task context is thread-local: concurrent actor tasks must not
        # attribute puts/events to each other's task ids
        self._task_ctx = threading.local()
        self._current_actor_id: Optional[ActorID] = None

        self.dispatch_handler: Optional[Callable[[dict], None]] = None
        #: WorkerExecutor hook: True while a task is queued/running (a
        #: reconnecting busy worker must not rejoin the idle pool)
        self.busy_probe: Optional[Callable[[], bool]] = None
        self._reconnect_gen: Optional[bytes] = None
        #: Installed by WorkerExecutor: called when the executing thread is
        #: about to block on a remote result / when it resumes (reference:
        #: CoreWorker NotifyDirectCallTaskBlocked, core_worker.cc)
        self.block_notifier = None
        self._early_dispatches: List[dict] = []
        self.pubsub_handlers: Dict[str, List[Callable]] = {}
        self.pg_events: Dict[bytes, dict] = {}
        self.pg_cond = threading.Condition()
        self._register_reply: Optional[dict] = None
        self._register_ev = threading.Event()
        self._stopped = threading.Event()
        self._timeline_buf: List[dict] = []

        # completion callbacks must not run on the pump thread (they may
        # materialize via blocking RPCs the pump itself fulfills)
        self._cb_queue: "SimpleQueue[Optional[Callable]]" = SimpleQueue()
        self._cb_thread = threading.Thread(
            target=self._cb_loop, name=f"{kind}-callbacks", daemon=True)
        self._cb_thread.start()

        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.DEALER)
        self.sock.setsockopt(zmq.IDENTITY, self.worker_id.binary())
        self.sock.setsockopt(zmq.LINGER, 0)
        # unbounded queues: a burst of task results must never be dropped
        # at the HWM (the control plane has no retransmit)
        self.sock.setsockopt(zmq.SNDHWM, 0)
        self.sock.setsockopt(zmq.RCVHWM, 0)
        self.sock.connect(P.socket_path(session_dir))
        # the flusher sends on it, the pump receives from it; its wake
        # channel also lets shutdown interrupt the pump's long poll
        self._ctl_sock = D.SharedSocket(self.ctx, self.sock)
        # direct peer channel (reference: direct_actor_transport.h — actor
        # calls and task results move worker<->worker without the broker).
        # The ROUTER is recv-only (pump thread); outgoing peer DEALERs are
        # owned by the flusher thread.
        D.ensure_dir(session_dir)
        self.direct_sock = self.ctx.socket(zmq.ROUTER)
        self.direct_sock.setsockopt(zmq.LINGER, 0)
        self.direct_sock.setsockopt(zmq.SNDHWM, 0)
        self.direct_sock.setsockopt(zmq.RCVHWM, 0)
        self.direct_sock.bind(D.direct_addr(session_dir, self.worker_id.binary()))
        self._peer_socks: Dict[bytes, list] = {}  # flusher-owned: [sock, last_used]
        self._last_peer_prune = time.time()
        # client-side actor submitter state machine (reference:
        # CoreWorkerDirectActorTaskSubmitter: per-actor connection state +
        # pending queue, direct_actor_task_submitter.h)
        self._actors: Dict[bytes, dict] = {}
        self._actors_lock = threading.Lock()
        # normal-task specs we own that have not completed (resubmitted to
        # a restarted controller on RECONNECT)
        self._inflight_specs: Dict[bytes, TaskSpec] = {}
        self._inflight_lock = threading.Lock()
        # all sends go through one flusher thread: preserves FIFO order,
        # moves pickling off the caller's critical path, and coalesces
        # consecutive task submissions into SUBMIT_BATCH messages
        # (reference: pipelined submission, direct_task_transport.h:157)
        self._out_q: "SimpleQueue[Optional[Tuple[bytes, Any]]]" = SimpleQueue()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name=f"{kind}-flush", daemon=True)
        self._flusher.start()
        self._pump = threading.Thread(target=self._pump_loop,
                                      name=f"{kind}-pump", daemon=True)
        self._pump.start()
        threading.Thread(target=self._tick_loop, name=f"{kind}-tick",
                         daemon=True).start()

    def _tick_loop(self) -> None:
        while not self._stopped.wait(2.0):
            if self.kind == "driver":
                # liveness poke: an idle driver otherwise never speaks, so
                # a restarted controller could never ask it to RECONNECT
                # (and its in-flight submissions would hang forever)
                self._send(P.PING, {})
            # GC latency bound, in every process: the deferred decrements
            # of dropped refs and the pending deltas below the batch
            # threshold reach the controller within one period, whether
            # the process is idle or busy (a worker that dropped an
            # actor's return held its last decrement for good)
            try:
                self.reference_counter.flush()
            except Exception:
                pass
            if self.kind == "driver":
                self.recorder.maybe_flush()
                self.metrics_reporter.maybe_report()

    @property
    def current_task_id(self) -> TaskID:
        return getattr(self._task_ctx, "task_id", self._driver_task_id)

    @current_task_id.setter
    def current_task_id(self, value: TaskID) -> None:
        self._task_ctx.task_id = value

    def _cb_loop(self) -> None:
        while True:
            fn = self._cb_queue.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:
                logger.exception("completion callback failed")

    # ------------------------------------------------------------ transport
    def _reliable_resend(self, target, mtype: bytes, payload) -> None:
        """Retransmit hook (reliable-layer thread): re-enqueue through
        the flusher so the resend takes the same path — stamped payloads
        pass through ``stamp()`` untouched."""
        if not self._stopped.is_set():
            self._out_q.put((target, mtype, payload))

    def _reliable_ack(self, route, payload) -> None:
        """Batched-ack hook: ship back over the link the stamped
        messages arrived on (None = the controller DEALER)."""
        if not self._stopped.is_set():
            self._out_q.put((route, P.MSG_ACK, payload))

    def _send(self, mtype: bytes, payload: Any) -> None:
        self._out_q.put((None, mtype, payload))

    def _send_events(self, evs: List[dict]) -> None:
        """Flight-recorder flush hook: fire-and-forget enqueue (the
        reliable layer gives the batch exactly-once-effect at the
        controller; the recorder's bounded ring means a dead link can
        never grow memory or block a task)."""
        if not self._stopped.is_set():
            self._send(P.TASK_EVENTS, {"events": evs})

    def _send_metric_report(self, payload: dict) -> None:
        """Metrics-reporter ship hook (same contract as
        :meth:`_send_events`)."""
        if not self._stopped.is_set():
            self._send(P.METRIC_REPORT, payload)

    def _send_direct(self, target: bytes, mtype: bytes, payload: Any) -> None:
        """Queue a message for a peer's direct channel (``target`` is the
        peer's identity bytes). Same-process sends short-circuit."""
        if target == self.worker_id.binary():
            try:
                self._on_message(mtype, payload)
            except Exception:
                logger.exception("%s: error in local direct %s", self.kind, mtype)
            return
        self._out_q.put((target, mtype, payload))

    def _send_many(self, msgs: List[Tuple[Optional[bytes], bytes, Any]]
                   ) -> None:
        """Enqueue several (target, mtype, payload) messages with ONE
        queue handoff — each put can cost a flusher-thread wakeup.
        Same-process targets still short-circuit."""
        rest = []
        me = self.worker_id.binary()
        for target, mtype, payload in msgs:
            if target == me:
                try:
                    self._on_message(mtype, payload)
                except Exception:
                    logger.exception("%s: error in local direct %s",
                                     self.kind, mtype)
            else:
                rest.append((target, mtype, payload))
        if rest:
            self._out_q.put(rest)

    def _sock_send(self, mtype: bytes, blob: bytes) -> None:
        self._ctl_sock.send_multipart([mtype, blob])

    def _peer_sock(self, target: bytes) -> "zmq.Socket":
        """Flusher-thread-only: lazily connected DEALER to a peer ROUTER."""
        ent = self._peer_socks.get(target)
        if ent is None:
            s = self.ctx.socket(zmq.DEALER)
            s.setsockopt(zmq.IDENTITY, self.worker_id.binary())
            s.setsockopt(zmq.LINGER, 0)
            s.setsockopt(zmq.SNDHWM, 0)
            s.connect(D.direct_addr(self.session_dir, target))
            ent = self._peer_socks[target] = [s, time.time()]
        else:
            ent[1] = time.time()
        return ent[0]

    def _prune_peer_socks(self, idle_s: float = 120.0) -> None:
        """Flusher-thread-only. ipc connects never fail, so a DEALER to a
        dead peer would otherwise queue messages forever (SNDHWM=0) and the
        socket itself leak; idle-pruning bounds both."""
        now = time.time()
        for target in [t for t, (_, used) in self._peer_socks.items()
                       if now - used > idle_s]:
            sock, _ = self._peer_socks.pop(target)
            try:
                sock.close(0)
            except Exception:
                pass

    def _send_deferred(self, mtype: bytes, payload: Any) -> None:
        """Queue a controller-bound message that tolerates a few ms of
        delay (TASK_DONE accounting for direct tasks — the owner already
        has the result; the controller only records). The flusher holds
        these up to ~3ms / 64 messages and ships ONE batch, so a sync
        call loop costs the controller one handler pass per batch
        instead of one per call."""
        self._out_q.put((_DEFER, mtype, payload))

    def _flush_loop(self) -> None:
        deferred: List[Tuple[bytes, Any]] = []
        deferred_at = 0.0
        while True:
            try:
                if deferred:
                    # bounded hold: wake in time to honor the 3ms window
                    wait = max(0.0,
                               deferred_at + 0.003 - time.monotonic())
                    try:
                        item = self._out_q.get(timeout=wait)
                    except Empty:
                        self._flush_box(None, deferred)
                        deferred = []
                        continue
                else:
                    item = self._out_q.get()
            except Exception:
                return
            batch = [item]
            while len(batch) < 512:
                try:
                    batch.append(self._out_q.get_nowait())
                except Empty:
                    break
            stop = False
            # per-target ordered message lists; None = controller
            boxes: Dict[Optional[bytes], List[Tuple[bytes, Any]]] = {}
            specs: List = []

            def close_specs() -> None:
                box = boxes.setdefault(None, [])
                if len(specs) == 1:
                    box.append((P.SUBMIT_TASK, {"spec": specs[0]}))
                elif specs:
                    box.append((P.SUBMIT_BATCH, {"specs": list(specs)}))
                specs.clear()

            for it in batch:
                if it is None:
                    stop = True
                    break
                # a list item is a multi-message put (_send_many)
                for target, mtype, payload in (
                        it if isinstance(it, list) else (it,)):
                    if target is _DEFER:
                        if not deferred:
                            deferred_at = time.monotonic()
                        deferred.append((mtype, payload))
                        continue
                    if target is None and mtype == P.SUBMIT_TASK:
                        specs.append(payload["spec"])
                        continue
                    if target is None:
                        close_specs()
                    boxes.setdefault(target, []).append((mtype, payload))
            close_specs()
            if deferred and (stop or len(deferred) >= 64
                             or boxes.get(None)):
                # ship alongside a controller-bound flush (free ride on
                # the same MSG_BATCH), at the size cap, or at shutdown
                boxes.setdefault(None, []).extend(deferred)
                deferred = []
            for target, msgs in boxes.items():
                self._flush_box(target, msgs)
            if time.time() - self._last_peer_prune > 30.0:
                self._last_peer_prune = time.time()
                self._prune_peer_socks()
            if stop:
                return

    def _flush_box(self, target: Optional[bytes],
                   msgs: List[Tuple[bytes, Any]]) -> None:
        if not msgs:
            return
        # getattr: unit tests drive _flush_box on bare fakes
        rel = getattr(self, "_reliable", None)
        if rel is not None:
            # stamp + ring-record critical one-way messages BEFORE the
            # chaos filter: a dropped message must already be tracked
            msgs = [(mt, rel.stamp(target, mt, pl)) for mt, pl in msgs]
            # a slow flush (a call carrying a large argument) can find one
            # retransmit queued twice: the same stamped dict would pickle
            # as ONE shared object, whose stamp the receiver's dedup pops
            # at the first copy, so the second copy would pass as new and
            # run a call twice. Ship each stamped object once a flush.
            seen = set()
            msgs = [(mt, pl) for mt, pl in msgs
                    if not (isinstance(pl, dict) and RD.STAMP in pl)
                    or not (id(pl) in seen or seen.add(id(pl)))]
        if getattr(self, "_chaos", None) is not None:
            msgs = self._chaos_filter(target, msgs)
            if not msgs:
                return
        send = self._sock_send if target is None else \
            (lambda mt, blob: self._peer_sock(target).send_multipart([mt, blob]))
        try:
            if len(msgs) == 1:
                send(msgs[0][0], P.dumps(msgs[0][1]))
            else:
                send(P.MSG_BATCH, P.dumps({"msgs": msgs}))
        except Exception:
            # one bad payload must not discard the whole batch: retry
            # each message individually, dropping only the culprit
            for mtype, payload in msgs:
                try:
                    send(mtype, P.dumps(payload))
                except Exception:
                    if not self._stopped.is_set():
                        logger.exception(
                            "%s: dropping unsendable %s", self.kind, mtype)

    def _chaos_filter(self, target: Optional[bytes],
                      msgs: List[Tuple[bytes, Any]]
                      ) -> List[Tuple[bytes, Any]]:
        """Fault-injection choke point for every outgoing message (the
        flusher thread owns all sends, so one hook covers the controller
        DEALER and every peer channel). Dropped messages vanish here;
        delayed ones re-enter the flusher queue on a timer; duplicates
        ship twice with one wire seq (receivers dedup)."""
        out: List[Tuple[bytes, Any]] = []
        for mtype, payload in msgs:
            for delay_s, pl in self._chaos.plan_send(target, mtype, payload):
                if delay_s > 0.0:
                    t = threading.Timer(delay_s, self._out_q.put,
                                        args=((target, mtype, pl),))
                    t.daemon = True
                    t.start()
                else:
                    out.append((mtype, pl))
        return out

    def request(self, mtype: bytes, payload: dict,
                timeout: Optional[float] = None) -> dict:
        rid = self.replies.new_request()
        payload = dict(payload, rid=rid)
        self._send(mtype, payload)
        reply = self.replies.wait(rid, timeout or self.config.rpc_timeout_s,
                                  mtype=mtype)
        if isinstance(reply, dict) and reply.get("__error__"):
            raise RuntimeError(reply["data"])
        return reply

    def _pump_loop(self) -> None:
        poller = zmq.Poller()
        self._ctl_sock.register(poller)
        poller.register(self.direct_sock, zmq.POLLIN)
        # long idle timeout: poll wakes instantly on traffic; frequent
        # timer wakeups across many processes starve small hosts
        while not self._stopped.is_set():
            try:
                events = dict(poller.poll(timeout=1000))
            except zmq.ZMQError:
                break
            # every turn: the socket's descriptor is edge-triggered
            for frames in self._ctl_sock.drain():
                try:
                    self._on_message(frames[0], P.loads(frames[1]))
                except Exception:
                    logger.exception("%s: error handling %s", self.kind,
                                     frames[0])
            if self.direct_sock in events:
                while True:
                    try:
                        frames = self.direct_sock.recv_multipart(zmq.NOBLOCK)
                    except zmq.ZMQError:
                        break
                    try:
                        # [sender identity, mtype, payload]
                        self._on_message(frames[1], P.loads(frames[2]),
                                         source=frames[0])
                    except Exception:
                        logger.exception("%s: error handling direct %s",
                                         self.kind, frames[1])

    def _on_message(self, mtype: bytes, m: dict, source=None) -> None:
        if self._chaos_dedup is not None and CH.check_dedup(
                self._chaos_dedup, m):
            return  # injected duplicate of a message already handled
        if self._reliable is not None:
            if mtype == P.MSG_ACK:
                self._reliable.on_ack(m)
                return
            # ``source`` routes the batched ack: None = controller
            # link, else the direct-channel sender's identity. Local
            # short-circuited sends are never stamped, so this no-ops.
            if self._reliable.on_receive(source, m):
                return  # retransmit duplicate of a handled message
        if mtype == P.MSG_BATCH:
            for sub_type, sub_payload in m["msgs"]:
                try:
                    self._on_message(sub_type, sub_payload, source)
                except Exception:
                    logger.exception("%s: error in batched %s", self.kind,
                                     sub_type)
            return
        if mtype == P.GENERIC_REPLY:
            self.replies.fulfill(m["rid"], m["data"])
        elif mtype == P.ERROR_REPLY:
            self.replies.fulfill(m["rid"], {"__error__": True, "data": m["data"]})
        elif mtype == P.TASK_RESULT:
            self._on_task_result(m)
        elif mtype in (P.TASK_DISPATCH, P.ACTOR_CALL, P.CANCEL_QUEUED):
            if mtype == P.CANCEL_QUEUED:
                m = dict(m, cancel_queued=True)
            if self.dispatch_handler is not None:
                self.dispatch_handler(m)
            else:
                # dispatched before the executor installed its handler
                # (registration reply races with first dispatch)
                self._early_dispatches.append(m)
        elif mtype == P.REGISTER_REPLY:
            self._register_reply = m
            self._register_ev.set()
        elif mtype == P.PUBSUB:
            for cb in self.pubsub_handlers.get(m["channel"], []) + \
                    self.pubsub_handlers.get("*", []):
                cb(m["channel"], m["data"])
        elif mtype == P.PG_UPDATE:
            with self.pg_cond:
                self.pg_events[m["pg_id"]] = m
                self.pg_cond.notify_all()
        elif mtype == P.RECONNECT:
            self._on_reconnect(m.get("gen"))
        elif mtype == P.FETCH_OBJECT:
            self._on_fetch_object(m)
        elif mtype == P.STREAM_ITEM:
            self._on_stream_item(m)
        elif mtype == P.STREAM_EOF:
            self._on_stream_eof(m)
        elif mtype == P.STREAM_CREDIT:
            if self.stream_credit_handler is not None:
                self.stream_credit_handler(m)
        elif mtype == P.TMPL_MISS:
            self._on_tmpl_miss(m)
        elif mtype == P.PROFILE_SELF:
            # sampling sleeps for the requested duration: never on the
            # pump thread
            threading.Thread(target=self._run_self_profile, args=(m,),
                             name="self-profile", daemon=True).start()
        elif mtype == P.LEASE_REVOKED:
            self._on_lease_revoked(m["worker"], m.get("dead", True))
        elif mtype == P.LEASE_GRANT:
            self._on_lease_grant(m.get("workers") or [])
        elif mtype == P.SHUTDOWN:
            self._stopped.set()

    def set_dispatch_handler(self, handler: Callable[[dict], None]) -> None:
        self.dispatch_handler = handler
        while self._early_dispatches:
            handler(self._early_dispatches.pop(0))

    def _register_msg(self) -> dict:
        m = {"kind": self.kind, "id": self.worker_id.binary(),
             "node_id": self.node_id.binary(), "pid": os.getpid()}
        if self._current_actor_id is not None:
            m["actor_id"] = self._current_actor_id.binary()
        if self.busy_probe is not None:
            try:
                m["busy"] = bool(self.busy_probe())
            except Exception:
                pass
        if self.kind == "driver" and self._register_ev.is_set():
            # re-registration keeps the assigned job identity (the default
            # job 0 before first registration must NOT be claimed)
            m["job_id"] = self.job_id.binary()
        return m

    def register(self, timeout: float = 30.0) -> dict:
        self._send(P.REGISTER, self._register_msg())
        if not self._register_ev.wait(timeout):
            raise TimeoutError("could not connect to controller")
        reply = self._register_reply
        if self.kind == "driver" and reply.get("job_id"):
            self.job_id = JobID(reply["job_id"])
            self._driver_task_id = TaskID.for_driver(self.job_id)
            self.current_task_id = self._driver_task_id
        return reply

    def _on_reconnect(self, gen: Optional[bytes]) -> None:
        """The controller restarted and lost its volatile state: re-send
        everything it needs from us, in one FIFO burst — identity first,
        then subscriptions, our live refcounts, and every unfinished task
        we own (reference: core workers/raylets resubscribe + resubmit on
        GCS restart; gcs_client reconnection path). At most once per
        controller generation: refcounts are absolute and tasks must not
        resubmit twice."""
        if gen is not None and gen == self._reconnect_gen:
            return
        self._reconnect_gen = gen
        logger.info("%s: controller restarted; re-announcing", self.kind)
        # worker leases died with the controller's grant table; the
        # inflight resubmit below covers direct tasks too
        with self._lease_lock:
            self._lease_pool.clear()
            self._lease_inflight.clear()
            self._direct_tids.clear()
            self._direct_backlog.clear()  # inflight resubmit covers them
            self._direct_backlog_bytes = 0
            self._lease_state = "none"
            # jittered: every driver re-leasing in lockstep against a
            # freshly-restarted controller is exactly the thundering
            # herd full jitter de-correlates
            self._lease_backoff_until = time.monotonic() + \
                self._lease_backoff.next_delay()
        self._send(P.REGISTER, self._register_msg())
        for channel in list(self.pubsub_handlers):
            if channel != "*":
                self._send(P.SUBSCRIBE, {"channel": channel})
        counts = self.reference_counter.all_counts()
        if counts:
            self._send(P.REF_DELTAS, {"deltas": counts})
        with self._inflight_lock:
            specs = list(self._inflight_specs.values())
        for spec in specs:
            if self._owner_local:
                # the resubmit runs controller-path: its results will be
                # directory-recorded, so the returns must be tracked
                for oid in spec.return_ids():
                    self.reference_counter.promote(oid)
            self._send(P.SUBMIT_TASK, {"spec": spec})
        # actor address long-polls in flight at the crash died with the
        # old controller's waiter lists: re-issue them or every call
        # queued behind RESOLVING hangs forever
        with self._actors_lock:
            resolving = [aid for aid, st in self._actors.items()
                         if st["state"] == "RESOLVING"]
        for aid in resolving:
            self._resolve_actor(aid)

    def shutdown(self) -> None:
        self._release_all_leases()
        self.reference_counter.flush()
        self.flush_timeline()
        self.recorder.flush()
        self.metrics_reporter.release()
        self._stopped.set()
        if self._reliable is not None:
            self._reliable.stop()
        self._cb_queue.put(None)
        # sentinel after the final enqueues: FIFO guarantees they flush
        self._out_q.put(None)
        self._flusher.join(timeout=2.0)
        self._ctl_sock.wake()
        self._pump.join(timeout=2.0)
        try:
            self._ctl_sock.close()
            self._ctl_sock.close_loop_end()
            self.direct_sock.close(0)
            for s, _ in self._peer_socks.values():
                s.close(0)
            self._peer_socks.clear()
        except Exception:
            pass
        if self.shm:
            self.shm.close()

    # ------------------------------------------------------------- refcount
    def _flush_ref_deltas(self, deltas: Dict[bytes, int]) -> None:
        if self._stopped.is_set():
            return
        try:
            self._send(P.REF_DELTAS, {"deltas": deltas})
        except Exception:
            pass

    # ------------------------------------------------------------ put / get
    def put(self, value: Any, _owner_hint: Optional[bytes] = None) -> ObjectRef:
        with self._lock:
            self._put_counter += 1
            oid = ObjectID.for_put(self.current_task_id, self._put_counter)
        # store BEFORE creating the ref: inline values become owner-local
        # (no controller entry, no ref deltas) and the suppression must be
        # in place before the ref's +1 registers
        meta = self._store_value(oid, value, notify=True)
        if meta.get("node_id") is None and self._owner_local:
            b = oid.binary()
            self.reference_counter.mark_untracked(oid)
            with self._meta_lock:
                self._local_objects[b] = None
                self._meta[b] = meta
        ref = ObjectRef(oid, self.worker_id)
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            m = runtime_metrics()
            m.puts.inc()
            m.put_bytes.inc(meta.get("size", 0))
        except Exception:
            pass
        if meta.get("node_id") is not None and self.shm is not None \
                and hasattr(self.shm, "evict"):
            # shm-resident put owned by this process: eligible for eager
            # eviction unless its ref escapes (see mark_ref_escaped)
            with self._eager_lock:
                self._eager_owned[oid.binary()] = None
        return ref

    def mark_ref_escaped(self, object_id_b: bytes) -> None:
        """The ref was serialized (task arg, nested put, any pickle) —
        another process may now reference the object, so the owner must
        never free it unilaterally; the controller's global refcount is
        the authority from here on."""
        with self._eager_lock:
            self._eager_owned.pop(object_id_b, None)
            self._escaped_refs[object_id_b] = None
            while len(self._escaped_refs) > 65536:
                self._escaped_refs.popitem(last=False)
        if self._owner_local and \
                object_id_b in self.reference_counter._untracked:
            # unlocked pre-filter (common case: not ours / already
            # promoted); promote() re-checks under its lock
            self._promote_escaped(object_id_b)

    def _promote_escaped(self, object_id_b: bytes) -> None:
        """An owner-local ref is leaving this process: hand the object's
        lifecycle to the controller (inject our live count as deltas) and
        publish its value so borrowers and dep-parked tasks can resolve —
        the lazy analog of the PUT_OBJECT every put used to send."""
        n = self.reference_counter.promote(ObjectID(object_id_b))
        if n < 0:
            return
        with self._meta_lock:
            meta = self._meta.get(object_id_b)
            if meta is None:
                # result not here yet: publish the moment it lands
                self._publish_on_result[object_id_b] = None
        if meta is not None:
            self._publish_object(object_id_b, meta)

    def _publish_object(self, object_id_b: bytes, meta: dict) -> None:
        payload = {"object_id": object_id_b}
        for k in ("inline", "node_id", "size", "error"):
            v = meta.get(k)
            if v is not None:
                payload[k] = v
        self._send(P.PUT_OBJECT, payload)

    def _run_self_profile(self, m: dict) -> None:
        """Dashboard-requested self-profile (reference: the reporter
        agent's py-spy endpoint; this is the in-process sampler that
        needs no external tooling). Replies with collapsed stacks — the
        flamegraph input format."""
        try:
            from ray_tpu_torch.util.profiling import sample_self
            s = sample_self(min(float(m.get("duration_s", 2.0)), 30.0),
                            interval_s=0.005)
            payload = {"rid": m.get("rid"), "collapsed": s.collapsed(),
                       "num_samples": s.num_samples,
                       "worker_id": self.worker_id.hex()}
        except Exception as e:  # noqa: BLE001
            payload = {"rid": m.get("rid"), "error": str(e)[:200]}
        self._send(P.PROFILE_RESULT, payload)

    def _on_fetch_object(self, m: dict) -> None:
        """Controller asks us (the owner) to publish an owner-local
        object a borrower is parked on."""
        b = m["object_id"]
        with self._meta_lock:
            meta = self._meta.get(b)
            if meta is None:
                self._publish_on_result[b] = None
        if meta is not None:
            self._publish_object(b, meta)

    def _on_owner_zero(self, oid: ObjectID) -> None:
        b = oid.binary()
        if self._owner_local:
            with self._meta_lock:
                was_local = self._local_objects.pop(b, False) is not False
                if was_local:
                    self._meta.pop(b, None)
            if was_local:
                # owner-local value: our copy is the only (or, if
                # escaped+published, a redundant) one — free it now.
                # NOTE _publish_on_result stays: an escaped-while-pending
                # borrower may still need the publish when it lands.
                self.memory_store.delete(oid)
                return
        with self._eager_lock:
            if b not in self._eager_owned or b in self._escaped_refs:
                return
            del self._eager_owned[b]
        try:
            freed = self.shm.evict(oid)
        except Exception:
            return
        if freed:
            with self._meta_lock:
                self._meta.pop(b, None)
            self.memory_store.delete(oid)
            if not self._stopped.is_set():
                try:
                    # deferrable: the extent is already recycled; the
                    # controller only drops bookkeeping
                    self._send_deferred(P.OWNER_FREE, {"object_ids": [b]})
                except Exception:
                    pass

    def _store_value(self, oid: ObjectID, value: Any, notify: bool) -> dict:
        """Serialize and store a value; returns result meta for TASK_DONE."""
        serialized = self.serialization.serialize(value)
        size = serialized.total_bytes()
        b = oid.binary()
        if size <= self.config.max_inline_object_size or self.shm is None:
            # small objects live in the in-process store (reference policy:
            # memory_store.h holds <100 KB objects only); a value holding
            # tensors is kept as its bytes, so that every get restores a
            # copy of its own (a tensor is mutable; see _cache_value)
            blob = serialized.to_bytes()
            meta = {"object_id": b, "inline": blob, "size": size}
            self.memory_store.put(
                oid, _MetaReady(meta) if serialized.holds_tensors else value)
            if notify and not self._owner_local:
                # owner-local mode publishes lazily on ref escape
                # (mark_ref_escaped) instead of on every put
                self._send(P.PUT_OBJECT, {"object_id": b, "inline": blob})
        else:
            # large objects live ONLY in shm — duplicating the value in
            # process memory would double the footprint of every big put
            # (local gets deserialize zero-copy from the sealed extent)
            try:
                view = None
                deadline = time.monotonic() + \
                    self.config.store_full_timeout_s
                collected = False
                while True:
                    try:
                        view = self.shm.create(oid, size)
                        break
                    except ObjectStoreFullError:
                        # Queue behind eviction like plasma's create
                        # request queue (create_request_queue.h): ask
                        # the node authority to spill LRU objects, drop
                        # our own GC-deferred zero-copy values ONCE
                        # (their reader leases block spilling), and
                        # wait for in-flight executions elsewhere to
                        # release theirs.
                        if not collected:
                            collected = True
                            import gc
                            gc.collect()
                        self._node_store_rpc("make_room", bytes=size)
                        if time.monotonic() >= deadline:
                            from ray_tpu_torch.core.native_store import (
                                STORE_DEBUG)
                            if STORE_DEBUG and hasattr(self.shm,
                                                       "_segment"):
                                seg = self.shm._segment()
                                rows = seg.list_sealed()
                                held = [(o.hex()[:12], sz, rc)
                                        for o, sz, rc in rows if rc > 0]
                                logger.warning(
                                    "STOREFULL inventory: %d sealed, "
                                    "%d reader-held (%d MB): %s",
                                    len(rows), len(held),
                                    sum(sz for _, sz, _ in held) >> 20,
                                    held[:40])
                            raise
                        time.sleep(0.2)
                serialized.write_to(view)
                self.shm.seal(oid)
            except FileExistsError:
                # duplicate execution (at-least-once after a controller
                # restart resubmitted a task that was already running):
                # the object is already here — keep the first copy
                pass
            meta = {"object_id": b, "node_id": self.node_id.binary(), "size": size}
            self.seed_meta(b, meta)
            if notify:
                self._send(P.PUT_OBJECT, {
                    "object_id": b, "node_id": self.node_id.binary(), "size": size})
        return meta

    def seed_meta(self, object_id_b: bytes, meta: dict) -> None:
        with self._meta_lock:
            self._meta[object_id_b] = meta

    def _restore_local(self, oid: ObjectID) -> Optional[memoryview]:
        """Restore a locally-spilled object and acquire a view,
        retrying while the node reports transient capacity pressure
        (segment full of reader-held extents). Returns None when the
        object is genuinely absent from this node."""
        deadline = time.monotonic() + self.config.store_full_timeout_s
        while True:
            try:
                # pid rides along so the node takes a reader lease FOR
                # US before replying: the extent cannot be re-spilled in
                # the reply->get_view window (the race that lost
                # over-budget shuffles under sustained spill thrash)
                reply = self._node_store_rpc(
                    "restore", object_id=oid.binary(), pid=os.getpid(),
                    timeout=60.0)
            except Exception:
                return None
            if reply.get("ok"):
                view = self.shm.get_view(oid, timeout=5.0)
                if reply.get("leased"):
                    # balance the node-held handshake lease now that we
                    # hold (or failed to take) our own
                    try:
                        self.shm._segment().release(oid)
                    except Exception:
                        pass
                if view is not None:
                    return view
                # re-spilled between reply and our lease: loop
            elif not reply.get("retry"):
                return None
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.3)

    def _node_store_rpc(self, op: str, timeout: float = 30.0,
                        **params) -> dict:
        """Blocking store-maintenance request to OUR node manager over
        the direct channel (make_room / restore spilled objects)."""
        rid = self.replies.new_request()
        node_identity = b"N" + self.node_id.binary()[:27]
        self._send_direct(node_identity, P.STORE_RPC,
                          dict(params, op=op, rid=rid))
        return self.replies.wait(rid, timeout, mtype=P.STORE_RPC) or {}

    def _on_task_result(self, m: dict) -> None:
        aid = m.get("actor_id")
        known = False
        if aid is not None:
            with self._actors_lock:
                st = self._actors.get(aid)
                if st is not None:
                    done_spec = st["inflight"].pop(m.get("task_id"), None)
                    known = known or done_spec is not None
                    self._unpin_task_args(done_spec)
        if m.get("task_id") is not None:
            with self._inflight_lock:
                done_spec = self._inflight_specs.pop(m["task_id"], None)
            known = known or done_spec is not None
            self._unpin_task_args(done_spec)
            self._on_direct_task_result(m["task_id"])
            st = self._stream_for(m["task_id"])
            if st is not None and m.get("error") is not None:
                # terminal failure of a streaming task (retries
                # exhausted / actor dead / cancelled): no more item
                # reports or replays are coming — fail the stream so
                # blocked consumers raise the typed error instead of
                # hanging on an index that will never arrive
                try:
                    st.fail(P.loads(m["error"]))
                except Exception:
                    from ray_tpu_torch.exceptions import RayTpuError
                    st.fail(RayTpuError("streaming task failed"))
                self._drop_stream(m["task_id"])
        err = m.get("error")
        rc = self.reference_counter
        via_controller = m.get("via_controller")
        for r in m.get("results", []):
            b = r["object_id"]
            failed = err is not None or r.get("error") is not None
            publish = drop = local_mark = False
            # ---- refcount classification OUTSIDE _meta_lock: promote()
            # and local_count() can fire owner-zero, which takes
            # _meta_lock (observed self-deadlock on the pump thread) ----
            if self._owner_local:
                if err is not None and r.get("error") is None:
                    # carry the task error into the stored meta so a
                    # FETCH_OBJECT publish reproduces it for borrowers
                    # (the controller no longer records it)
                    r = dict(r, error=err)
                untracked = b in rc._untracked  # unlocked peek: promote
                # re-checks under its own lock
                if untracked and (via_controller
                                  or r.get("node_id") is not None):
                    # controller-path task (its directory records the
                    # results) or shm result (the extent is
                    # controller-side state): counts must flow
                    rc.promote(ObjectID(b))
                elif untracked:
                    local_mark = True  # stays owner-local
                else:
                    # promoted earlier (escape) or dead-before-arrival
                    with self._meta_lock:
                        pending_pub = b in self._publish_on_result
                    if not pending_pub and \
                            rc.local_count(ObjectID(b)) == 0:
                        drop = True
            with self._meta_lock:
                existing = self._meta.get(b)
                if not known and failed and existing is not None \
                        and existing.get("error") is None and (
                            existing.get("inline") is not None
                            or existing.get("node_id") is not None):
                    # duplicate execution (at-least-once resubmit raced
                    # a completion already in flight): first result
                    # wins — a duplicate failing on since-freed args
                    # must not poison good metas. Unknown-tid SUCCESS
                    # results still record: lineage reconstruction
                    # legitimately re-runs tasks whose spec we already
                    # retired.
                    continue
                if self._owner_local:
                    publish = b in self._publish_on_result
                    if publish:
                        del self._publish_on_result[b]
                        drop = False  # escaped meanwhile: must record
                    if drop:
                        # every ref died before the result arrived and
                        # nothing escaped: drop it. A shm extent (or a
                        # controller-recorded entry, for controller-path
                        # tasks) still exists — a 0-delta tells the
                        # controller the object lived and fully died.
                        pass
                    else:
                        if local_mark:
                            self._local_objects[b] = None
                        self._meta[b] = r
                else:
                    self._meta[b] = r
            if drop:
                if r.get("node_id") is not None or via_controller:
                    self._send(P.REF_DELTAS, {"deltas": {b: 0}})
                continue
            if publish:
                self._publish_object(b, r)
            oid = ObjectID(b)
            # materialize lazily at get(); but wake any waiter now
            self.memory_store.put(oid, _MetaReady(r))

    # ------------------------------------------------- streaming generators
    def submit_streaming_task(self, spec: TaskSpec):
        """Submit a ``num_returns="streaming"`` task and return the
        caller-side :class:`ObjectRefGenerator` (reference:
        ``CoreWorker::SubmitTask`` with ``returns_dynamically``). The
        stream record is registered BEFORE submission so the first
        ``STREAM_ITEM`` cannot race it."""
        from ray_tpu_torch.core.streaming import ObjectRefGenerator, StreamState
        tid_b = spec.task_id.binary()
        if spec.trace is None:
            spec.trace = EV.child_trace(spec.task_id.hex())
        state = StreamState(self, tid_b)
        state.trace = spec.trace  # STREAM_CREDIT carries the link back
        with self._streams_lock:
            self._streams[tid_b] = state
        self.submit_task(spec)
        return ObjectRefGenerator(state)

    def _stream_for(self, tid_b: Optional[bytes]):
        if tid_b is None:
            return None
        with self._streams_lock:
            return self._streams.get(tid_b)

    def _drop_stream(self, tid_b: bytes) -> None:
        with self._streams_lock:
            self._streams.pop(tid_b, None)

    def _on_stream_item(self, m: dict) -> None:
        st = self._stream_for(m.get("task_id"))
        meta = m["meta"]
        if st is None:
            # not (or no longer) a stream we track: a lineage replay
            # re-reporting items whose stream was fully consumed, or a
            # borrower process. Seed the meta so parked gets resolve;
            # no stream bookkeeping, no ref minting.
            b = meta["object_id"]
            with self._meta_lock:
                self._meta[b] = meta
            self.memory_store.put(ObjectID(b), _MetaReady(meta), force=True)
            return
        st.on_item(m["index"], meta, m.get("worker"))

    def _on_stream_eof(self, m: dict) -> None:
        st = self._stream_for(m.get("task_id"))
        if st is not None:
            st.on_eof(m["count"], m.get("worker"))

    def _stream_send_credit(self, tid_b: bytes, consumed: int,
                            producer: Optional[bytes],
                            trace: Optional[tuple] = None) -> None:
        """Consumer progress report: cumulative, so loss-tolerant and
        idempotent; opens the producer's backpressure window."""
        if producer is None or self._stopped.is_set():
            return
        self._send_direct(producer, P.STREAM_CREDIT,
                          {"task_id": tid_b, "consumed": consumed,
                           "trace": trace})

    def _stream_finished(self, tid_b: bytes) -> None:
        """StreamState hook: the consumer reached EOF — drop the routing
        record (late lineage replays fall back to plain meta seeding)."""
        self._drop_stream(tid_b)

    def _close_stream(self, state) -> None:
        """Early consumer termination: drop buffered item refs, cancel
        the producer, forget the stream."""
        tid_b = state.task_id_b
        already_done = state.eof_index is not None and state.error is None \
            and not state.items
        refs = state.close()
        self._drop_stream(tid_b)
        # dropping the buffered refs is what frees unconsumed items —
        # each was +1'd at report time; the consumer never took them
        del refs
        with self._inflight_lock:
            self._inflight_specs.pop(tid_b, None)
        if not already_done and not self._stopped.is_set():
            # cancel the producer (it may still be yielding into the
            # backpressure window); route like any task cancel
            try:
                ref = ObjectRef(ObjectID.for_task_return(TaskID(tid_b), 1),
                                self.worker_id, _register=False)
                self.cancel(ref, force=False)
            except Exception:
                logger.exception("stream cancel failed")

    @staticmethod
    def _find_weakref_targets(value, depth: int = 3) -> list:
        return _weakref_targets(value, depth)

    def _unpin_task_args(self, spec) -> None:
        """Balance add_submitted_task_ref once the task's result is in:
        the arg pin exists so an arg object can't be freed while its
        consumer is still in flight. Without the release every task-arg
        object stays pinned (count never reaches zero) and its extent
        leaks for the session's lifetime."""
        if spec is None:
            return
        for _, oid in spec.arg_refs:
            self.reference_counter.remove_submitted_task_ref(oid)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            out.append(self._get_one(ref, remaining))
        return out[0] if single else out

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]):
        """Dual-path get (reference: CoreWorker::GetObjects dual-path
        memory-store/plasma resolution, core_worker.cc:1478): try the
        in-process store, then local shm, then ask the controller for the
        location (which blocks server-side until the object exists and is
        local, triggering transfer/reconstruction as needed)."""
        oid = ref.id()
        b = oid.binary()
        found, value = self.memory_store.try_get(oid)
        if found and not isinstance(value, _MetaReady):
            return value
        if isinstance(value, _MetaReady):
            return self._materialize(oid, value.meta)
        with self._meta_lock:
            meta = self._meta.get(b)
        if meta is not None:
            return self._materialize(oid, meta)
        if self.shm is not None and self.shm.contains(oid):
            return self._materialize(
                oid, {"object_id": b, "node_id": self.node_id.binary()})
        # Not local: if we own the object its TASK_RESULT will be pushed to
        # us; otherwise ask the controller (async; reply lands in the memory
        # store as _MetaReady). Block with the caller's timeout either way.
        owned = ref.owner is not None and ref.owner == self.worker_id
        if not owned:
            self._ensure_location_probe(
                b, ref.owner.binary() if ref.owner is not None else None)
        from ray_tpu_torch.core.memory_store import WeakCacheExpired
        token = self._enter_blocked()
        try:
            if owned:
                # grace-then-probe: the direct TASK_RESULT push normally
                # lands in ms, but if it was lost (producer killed with
                # the result still in its send queue) waiting on it alone
                # hangs forever — fall back to asking the controller,
                # which answers from its task table, reconstructs via
                # lineage, or fails the object loudly.
                from ray_tpu_torch.exceptions import GetTimeoutError
                grace = 5.0 if timeout is None else min(5.0, timeout)
                try:
                    value = self.memory_store.get(oid, grace)
                except GetTimeoutError:
                    self._ensure_location_probe(b)
                    rest = None if timeout is None else timeout - grace
                    value = self.memory_store.get(oid, rest)
            else:
                value = self.memory_store.get(oid, timeout)
        except WeakCacheExpired:
            # the value existed, was weak-cached, and got collected
            # between our checks — re-materialize from shm via meta
            # (the finally below balances _enter_blocked exactly once)
            return self._get_one(ref, timeout)
        finally:
            self._exit_blocked(token)
        if isinstance(value, _MetaReady):
            value = self._materialize(oid, value.meta)
        return value

    def _enter_blocked(self) -> bool:
        """Blocked-worker protocol: a task about to wait on a remote result
        hands its unstarted pipeline back and releases its cpu so the
        cluster keeps making progress (avoids nested-task deadlock)."""
        nb = self.block_notifier
        if nb is None:
            return False
        tid = getattr(self._task_ctx, "task_id", None)
        if tid is None or tid == self._driver_task_id:
            return False
        return nb.on_block()

    def _exit_blocked(self, token: bool) -> None:
        if token and self.block_notifier is not None:
            self.block_notifier.on_unblock()

    @staticmethod
    def _count_materialized(nbytes: int) -> None:
        """Inbound transfer accounting: bytes of object payload this
        process pulled in to satisfy a get (the pipeline train-mode
        tests assert the driver's per-step inbound stays scalar-sized
        — no grad/param bytes through the driver)."""
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            runtime_metrics().materialized_bytes.inc(nbytes)
        except Exception:
            pass

    def _materialize(self, oid: ObjectID, meta: dict):
        if meta.get("error") is not None:
            err = P.loads(meta["error"])
            self.memory_store.put(oid, None, error=err, force=True)
            raise fresh_error(err)
        if meta.get("inline") is not None:
            view = memoryview(meta["inline"])
            value, _ = self.serialization.deserialize_from_view(view)
            self._cache_value(oid, value, meta, holds_tensors(view))
            self._count_materialized(len(meta["inline"]))
            return value
        # shared-memory object
        node_b = meta.get("node_id")
        if self.shm is not None and (node_b == self.node_id.binary()
                                     or self.shm.contains(oid)):
            # fast probe first: a locally-SPILLED object will never
            # appear however long we poll — restore it instead of
            # burning the full timeout (background eviction makes
            # spilled-but-local routine)
            view = self.shm.get_view(oid, timeout=0.05)
            if view is None and node_b == self.node_id.binary():
                # not in the segment but supposedly local: it may have
                # been spilled to disk — ask the node to restore it
                # (reference: AsyncRestoreSpilledObject before a local
                # plasma get gives up)
                view = self._restore_local(oid)
            if view is not None:
                value, _, bufs = \
                    self.serialization.deserialize_from_view_tracked(view)
                self._count_materialized(view.nbytes)
                self._cache_shm_value(oid, value, bufs, holds_tensors(view))
                return value
        # remote: ask controller to make it local (or hand us inline
        # bytes). Bounded retry loop: the reply only lands once the
        # object is supposedly local, but the local copy can be a
        # disk-faulted spill — the node reports the stale holder
        # (PULL_FAILED) while we re-ask, and the controller re-pulls
        # from another holder / reconstructs before answering again.
        # Only after the retries is the typed ObjectLostError raised.
        for attempt in range(3):
            reply = self.request(P.GET_LOCATION, {
                "object_id": oid.binary(),
                "want_node": self.node_id.binary()},
                timeout=self.config.rpc_timeout_s * 4)
            if reply.get("error") is not None:
                err = P.loads(reply["error"])
                self.memory_store.put(oid, None, error=err, force=True)
                raise fresh_error(err)
            if reply.get("inline") is not None:
                view = memoryview(reply["inline"])
                value, _ = self.serialization.deserialize_from_view(view)
                self._cache_value(oid, value, reply, holds_tensors(view))
                self._count_materialized(len(reply["inline"]))
                return value
            if self.shm is None:
                raise RuntimeError(
                    "no shm store attached; cannot fetch object")
            view = self.shm.get_view(oid, timeout=2.0)
            if view is None:
                view = self._restore_local(oid)
            if view is not None:
                value, _, bufs = \
                    self.serialization.deserialize_from_view_tracked(view)
                self._count_materialized(view.nbytes)
                self._cache_shm_value(oid, value, bufs, holds_tensors(view))
                return value
            time.sleep(0.2 * (attempt + 1))
        from ray_tpu_torch.exceptions import ObjectLostError
        raise ObjectLostError(oid)

    def _cache_value(self, oid: ObjectID, value: Any, meta: dict,
                     tensors: bool = False) -> None:
        """Cache a materialized inline value for later gets. A value that
        held tensors is cached as its meta instead: its tensors were
        restored as writable copies, and a second get must not return
        the tensor a first caller may have written into."""
        self.memory_store.put(
            oid, _MetaReady(meta) if tensors else value, force=True)

    def _cache_shm_value(self, oid: ObjectID, value: Any,
                         buffer_views: Optional[list] = None,
                         tensors: bool = False) -> None:
        """Cache a zero-copy shm value WEAKLY and release the reader
        ledger when the last ALIAS of the extent dies (reference:
        plasma buffers pin an object only while the client still holds
        them). A strong cache would pin the extent for the process
        lifetime — every large task arg a worker ever saw would leak.

        The release anchors are the out-of-band BUFFER VIEWS from
        deserialization: arrow buffers and numpy bases reference
        exactly these memoryview objects, so they die — by refcount,
        no gc needed — precisely when the last table slice / array
        view / concat product is gone. Finalizing on the VALUE is both
        too early (a table can die while its buffers live on inside
        derived objects — data corruption once the extent recycles)
        and too late (arrow tables sit in reference cycles, so a busy
        process pins consumed blocks until some distant gen-2 GC)."""
        import weakref
        # tensors come back as copies (see _cache_value): cache where the
        # bytes are, so every get restores its own
        cached = _MetaReady({"object_id": oid.binary(),
                             "node_id": self.node_id.binary()}) \
            if tensors else None
        anchors = list(buffer_views or ())
        if not anchors and cached is None:
            # legacy path (no tracked buffers): walk the value
            anchors = _weakref_targets(value)
        if not anchors:
            # nothing aliases the extent (pure-copy value): release the
            # ledger now and cache strongly
            self.memory_store.put(oid, cached or value, force=True)
            self.shm.release(oid)
            return
        remaining = [len(anchors)]
        shm = self.shm

        def _release(_=None):
            remaining[0] -= 1
            if remaining[0] == 0:
                try:
                    shm.release(oid)
                except Exception:
                    pass

        for t in anchors:
            weakref.finalize(t, _release)
        if cached is not None:
            self.memory_store.put(oid, cached, force=True)
        else:
            self.memory_store.put(oid, value, force=True, weak=True)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """Event-driven wait: one ``on_ready`` hook per pending ref trips a
        counter; no polling loop, no per-ref threads (reference:
        CoreWorker::Wait's fused memory-store/plasma waiter,
        core_worker.cc:1807)."""
        if num_returns > len(refs):
            raise ValueError(
                f"num_returns ({num_returns}) exceeds the number of refs "
                f"({len(refs)})")
        done = threading.Event()
        lock = threading.Lock()
        ready_flags = [False] * len(refs)
        count = [0]
        hooked: List[Tuple[ObjectID, Callable]] = []

        def _mark(i: int) -> None:
            with lock:
                if ready_flags[i]:
                    return
                ready_flags[i] = True
                count[0] += 1
                if count[0] >= num_returns:
                    done.set()

        for i, ref in enumerate(refs):
            oid = ref.id()
            b = oid.binary()
            with self._meta_lock:
                have_meta = b in self._meta
            if have_meta or self.memory_store.contains(oid):
                _mark(i)
                continue
            cb = (lambda i: lambda value, error: _mark(i))(i)
            hooked.append((oid, cb))
            self.memory_store.on_ready(oid, cb)
            if ref.owner is None or ref.owner != self.worker_id:
                self._ensure_location_probe(
                    b, ref.owner.binary() if ref.owner is not None else None)
        with lock:
            if count[0] >= num_returns:
                done.set()
        if not done.is_set():
            token = self._enter_blocked()
            try:
                done.wait(timeout)
            finally:
                self._exit_blocked(token)
        for oid, cb in hooked:
            self.memory_store.remove_callback(oid, cb)
        ready: List[ObjectRef] = []
        pending: List[ObjectRef] = []
        with lock:
            for i, ref in enumerate(refs):
                if ready_flags[i] and len(ready) < num_returns:
                    ready.append(ref)
                else:
                    pending.append(ref)
        return ready, pending

    def _ensure_location_probe(self, object_id_b: bytes,
                               owner_b: Optional[bytes] = None) -> None:
        """Ask the controller (once) where an object lives; the reply lands
        in the meta table + memory store from the pump thread. The
        controller holds the request server-side until the object exists,
        so this doubles as a remote-completion subscription. A stale probe
        (no reply within the retry window — e.g. the message was dropped)
        is re-issued rather than wedging the object forever; the abandoned
        ReplyWaiter callback entry is bounded to one per window."""
        now = time.monotonic()
        with self._meta_lock:
            if object_id_b in self._meta:
                return
            started = self._pending_locations.get(object_id_b)
            if started is not None and \
                    now - started < self.config.rpc_timeout_s * 4:
                return
            self._pending_locations[object_id_b] = now

        def on_reply(reply, b=object_id_b):
            with self._meta_lock:
                self._meta[b] = reply
                self._pending_locations.pop(b, None)
            self.memory_store.put(ObjectID(b), _MetaReady(reply))

        rid = self.replies.new_request(callback=on_reply)
        msg = {"object_id": object_id_b, "rid": rid,
               "want_node": self.node_id.binary()}
        if owner_b is not None:
            # lets the controller fetch an owner-local object's value
            # from its owner when the directory has no entry
            msg["owner"] = owner_b
        self._send(P.GET_LOCATION, msg)

    def register_completion_callback(self, ref: ObjectRef, cb: Callable) -> None:
        oid = ref.id()

        def materialize_and_call(value, error):
            from ray_tpu_torch.core.memory_store import WeakExpired
            if isinstance(value, WeakExpired):
                with self._meta_lock:
                    meta = self._meta.get(oid.binary())
                if meta is None:
                    # locally-materialized object with no recorded meta:
                    # the bytes are still in the local store
                    meta = {"object_id": oid.binary(),
                            "node_id": self.node_id.binary()}
                value = _MetaReady(meta)
            if isinstance(value, _MetaReady):
                try:
                    value = self._materialize(oid, value.meta)
                    error = None
                except BaseException as e:  # noqa: BLE001
                    value, error = None, e
            cb(value, error)

        def wrapper(value, error):
            # hop off the pump thread: materialization may issue blocking
            # RPCs that only the pump can fulfill
            self._cb_queue.put(lambda: materialize_and_call(value, error))

        # large own puts live only in shm (meta seeded, store empty):
        # complete immediately instead of waiting on a store event
        with self._meta_lock:
            meta = self._meta.get(oid.binary())
        if meta is not None and not self.memory_store.contains(oid):
            wrapper(_MetaReady(meta), None)
            return
        self.memory_store.on_ready(oid, wrapper)

    # ---------------------------------------------------------- submission
    def next_task_id(self) -> TaskID:
        return TaskID.for_normal_task(self.job_id)

    def serialize_args(self, args: tuple, kwargs: dict
                       ) -> Tuple[bytes, List[Tuple[int, ObjectID]], List[ObjectID]]:
        """Top-level ObjectRef args become placeholders resolved pre-exec
        (reference: dependency_resolver.cc); nested refs stay borrowed."""
        if not args and not kwargs:
            # no-arg calls dominate fan-out workloads: one cached blob
            # instead of a fresh cloudpickle Pickler per submission
            blob = self._empty_args_blob
            if blob is None:
                blob = self._empty_args_blob = \
                    self.serialization.serialize(((), {})).to_bytes()
            return blob, [], []
        arg_refs: List[Tuple[int, ObjectID]] = []
        new_args = []
        for i, a in enumerate(args):
            if isinstance(a, ObjectRef):
                arg_refs.append((len(arg_refs), a.id()))
                new_args.append(_ArgPlaceholder(len(arg_refs) - 1))
            else:
                new_args.append(a)
        new_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, ObjectRef):
                arg_refs.append((len(arg_refs), v.id()))
                new_kwargs[k] = _ArgPlaceholder(len(arg_refs) - 1)
            else:
                new_kwargs[k] = v
        serialized = self.serialization.serialize((tuple(new_args), new_kwargs))
        contained = [r.id() for r in serialized.contained_refs]
        return serialized.to_bytes(), arg_refs, contained

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        spec.owner = self.worker_id
        if spec.trace is None:
            # causal trace propagation: inherit the submitting thread's
            # context (a task executing under a propagated trace, or a
            # tracing.span) — else this task roots a new trace
            spec.trace = EV.child_trace(spec.task_id.hex())
        # register return refs against OUR counter directly — the
        # ObjectRef ctor's context lookup (global-worker resolve per
        # ref) is measurable on the fan-out hot path
        rc = self.reference_counter
        refs = []
        owner_local = self._owner_local
        for oid in spec.return_ids():
            if owner_local:
                # returns start owner-local (suppressed deltas); promoted
                # below if the task spills to the controller path, at
                # result arrival if the result is shm, or on ref escape
                rc.mark_untracked(oid)
            r = ObjectRef(oid, self.worker_id, _register=False)
            rc.add_local_reference(r)
            r._registered = True
            refs.append(r)
        for _, oid in spec.arg_refs:
            self.reference_counter.add_submitted_task_ref(oid)
            if owner_local and oid.binary() in rc._untracked:
                # a top-level arg ref leaves this process without being
                # pickled (it rides spec.arg_refs as a raw id): that is
                # an escape — the consumer and any dep-parking need the
                # object controller-visible. Shm objects are already
                # directory-tracked; only owner-local ones promote.
                self._promote_escaped(oid.binary())
        # deltas ride the threshold/periodic flush — flushing per submit
        # would cost a REF_DELTAS apply per task on the controller loop
        if spec.is_actor_task:
            self._submit_actor_task(spec)
        else:
            # owner-side pending record: a restarted controller has no
            # task table, so WE resubmit on RECONNECT (reference: the
            # owning core worker holds the spec, not the GCS)
            with self._inflight_lock:
                self._inflight_specs[spec.task_id.binary()] = spec
            if not self._try_direct_submit(spec):
                if owner_local:
                    # controller-path task: the controller records its
                    # results in the directory, so the return refs must
                    # be controller-tracked from the start
                    for oid in spec.return_ids():
                        rc.promote(oid)
                if spec.arg_refs:
                    # owner-side dependency seeding: attach what we know
                    # about arg objects so the controller can resolve
                    # deps it never learned of (a producer killed with
                    # its TASK_DONE unflushed leaves a directory hole;
                    # our direct TASK_RESULT still recorded the meta)
                    metas = {}
                    with self._meta_lock:
                        for _, oid in spec.arg_refs:
                            am = self._meta.get(oid.binary())
                            if am and am.get("error") is None and (
                                    am.get("node_id") is not None
                                    or (am.get("inline") is not None
                                        and len(am["inline"]) <= 1 << 16)):
                                metas[oid.binary()] = am
                    if metas:
                        spec.arg_metas = metas
                self._send(P.SUBMIT_TASK, {"spec": spec})
        self._record_event(spec, "submitted")
        self.recorder.record_task(
            EV.SUBMITTED, spec.task_id.hex(), spec.trace,
            name=spec.name or spec.function.qualname)
        return refs

    # ---------------------------------------------- direct normal tasks
    def _try_direct_submit(self, spec: TaskSpec) -> bool:
        """Push a dependency-free default-shape task straight to a
        leased worker. Returns False when the controller path should
        handle it (deps, placement constraints, custom resources, no
        lease capacity)."""
        if self.kind != "driver" or spec.arg_refs \
                or spec.is_actor_creation \
                or spec.scheduling_strategy.kind != "DEFAULT":
            return False
        res = spec.resources
        if res and (set(res) - {"CPU"} or res.get("CPU", 1.0) > 1.0):
            return False
        with self._lease_lock:
            if self._lease_state == "none":
                if time.monotonic() >= self._lease_backoff_until:
                    self._lease_state = "pending"
                    self._request_leases()
                return False
            if self._lease_state == "pending":
                # grant in flight: commit the burst to the direct path
                # now — spilling to the controller while every CPU is
                # about to be lease-held just feeds the starvation
                # reclaimer (revoke/grant thrash measured at ~2.4x the
                # per-task cost of waiting for the grant)
                return self._backlog_locked(spec)
            if self._lease_state != "ready" or not self._lease_pool:
                return False
            w = self._pick_leased_worker_locked()
            if w is None:
                # saturated: queue locally and drain on completions.
                # The caps bound driver memory, not throughput — the
                # controller path dispatches to the same workers but
                # costs ~3 extra controller-loop hops per task, so it
                # only wins once the backlog is pathological. A growing
                # backlog also re-requests leases sized to demand so a
                # big cluster's idle workers are drawn into the pool
                # (the controller parks what it can't grant yet).
                took = self._backlog_locked(spec)
                if took and not self._lease_req_inflight and \
                        time.monotonic() >= self._lease_topup_backoff and \
                        len(self._direct_backlog) > \
                        len(self._lease_pool) * \
                        self.config.dispatch_pipeline_depth:
                    self._request_leases(self._lease_want_locked())
                return took
            self._direct_tids[spec.task_id.binary()] = w
        self._dispatch_direct(w, spec)
        return True

    def _dispatch_direct(self, w: bytes, spec: TaskSpec) -> None:
        """Peer-to-peer dispatch onto a leased worker (one site for the
        DISPATCHED flight-recorder event)."""
        self.recorder.record_task(EV.DISPATCHED, spec.task_id.hex(),
                                  spec.trace, worker=w.hex()[:12])
        self._send_direct(w, P.TASK_DISPATCH,
                          {"spec": spec, "driver_leased": True})

    def _pick_leased_worker_locked(self) -> Optional[bytes]:
        depth = self.config.dispatch_pipeline_depth
        best, best_n = None, depth
        for w in self._lease_pool:
            n = self._lease_inflight.get(w, 0)
            if n < best_n:
                best, best_n = w, n
        if best is not None:
            self._lease_inflight[best] = best_n + 1
        return best

    def _backlog_locked(self, spec: TaskSpec) -> bool:
        """Caller holds _lease_lock: queue a spec for the direct path if
        the count/byte caps allow. Returns False to spill to the
        controller instead."""
        if len(self._direct_backlog) >= self._direct_backlog_cap or \
                self._direct_backlog_bytes >= \
                self._direct_backlog_bytes_cap:
            return False
        self._direct_backlog.append(spec)
        self._direct_backlog_bytes += len(spec.args_blob) + 512
        return True

    def _pop_backlog_locked(self) -> TaskSpec:
        spec = self._direct_backlog.popleft()
        self._direct_backlog_bytes -= len(spec.args_blob) + 512
        if not self._direct_backlog:
            self._direct_backlog_bytes = 0
        return spec

    def _lease_want_locked(self) -> int:
        """How many leases demand justifies: enough workers to cover the
        backlog at the configured pipeline depth, within sane bounds."""
        depth = max(1, self.config.dispatch_pipeline_depth)
        want = (len(self._direct_backlog) + depth - 1) // depth
        return max(4, min(1024, want))

    def _drain_backlog_locked(self) -> List[Tuple[bytes, TaskSpec]]:
        """Caller holds _lease_lock: assign backlogged specs to leased
        workers up to the pipeline depth; returns the dispatches."""
        sends = []
        while self._direct_backlog and self._lease_pool:
            w = self._pick_leased_worker_locked()
            if w is None:
                break
            spec = self._pop_backlog_locked()
            self._direct_tids[spec.task_id.binary()] = w
            sends.append((w, spec))
        return sends

    def _request_leases(self, count: int = 4) -> None:
        self._lease_req_inflight = True

        def on_reply(reply):
            workers = (reply or {}).get("workers") or []
            spill: List[TaskSpec] = []
            sends: List[Tuple[bytes, TaskSpec]] = []
            with self._lease_lock:
                self._lease_req_inflight = False
                if workers:
                    self._lease_pool.extend(workers)
                    self._lease_state = "ready"
                    self._lease_backoff.reset()
                    self._topup_backoff.reset()
                    # tasks backlogged while this request was in
                    # flight: dispatch onto the fresh capacity NOW —
                    # with no direct tasks inflight there are no
                    # completions to drain them otherwise
                    sends = self._drain_backlog_locked()
                elif self._lease_pool:
                    # empty TOP-UP grant: the cluster is fully leased
                    # (usually by us). We still hold workers with tasks
                    # in flight, so completions WILL drain the backlog
                    # at direct-path cost — spilling it to the
                    # controller here ping-pongs ~half of every big
                    # burst onto the slow path (measured: 1012/2000
                    # spilled, tasks_async capped at ~4.4k/s). Keep the
                    # pool, just stop re-asking for a while (growing,
                    # jittered: repeat empty grants back off further).
                    self._lease_topup_backoff = time.monotonic() + \
                        self._topup_backoff.next_delay()
                else:
                    # nothing grantable and we hold no capacity at all;
                    # retry later. Tasks optimistically backlogged while
                    # the request was in flight must not starve — route
                    # them through the controller after all.
                    self._lease_state = "none"
                    self._lease_backoff_until = time.monotonic() + \
                        self._lease_backoff.next_delay()
                    while self._direct_backlog:
                        spill.append(self._pop_backlog_locked())
            for w, spec in sends:
                self._dispatch_direct(w, spec)
            for spec in spill:
                if self._owner_local:
                    # spilling to the controller path: returns become
                    # directory-recorded — track them
                    for oid in spec.return_ids():
                        self.reference_counter.promote(oid)
                self._send(P.SUBMIT_TASK, {"spec": spec})

        rid = self.replies.new_request(callback=on_reply)
        self._send(P.LEASE_WORKERS, {"count": count, "rid": rid})

    def _on_lease_grant(self, workers: List[bytes]) -> None:
        """Deferred grant arrived (parked request): extend the pool and
        drain backlog onto the new capacity."""
        with self._lease_lock:
            self._lease_pool.extend(workers)
            if self._lease_pool:
                self._lease_state = "ready"
                self._lease_backoff.reset()
            sends = self._drain_backlog_locked()
        for w, spec in sends:
            self._dispatch_direct(w, spec)

    def _on_direct_task_result(self, tid_b: bytes) -> None:
        send = None
        with self._lease_lock:
            w = self._direct_tids.pop(tid_b, None)
            if w is not None and w in self._lease_inflight:
                n = self._lease_inflight[w] - 1
                if n <= 0:
                    self._lease_inflight.pop(w, None)
                else:
                    self._lease_inflight[w] = n
            if self._direct_backlog and self._lease_pool:
                nxt = self._pick_leased_worker_locked()
                if nxt is not None:
                    spec = self._pop_backlog_locked()
                    self._direct_tids[spec.task_id.binary()] = nxt
                    send = (nxt, spec)
        if send is not None:
            self._dispatch_direct(send[0], send[1])

    def _on_lease_revoked(self, worker: bytes,
                          dead: bool = True) -> None:
        """The controller took a leased worker back. If the worker DIED,
        resubmit its in-flight specs via the controller path (anything
        still tracked here never reported a result). If it was merely
        reclaimed (queue starvation), its queued direct tasks still
        complete — just stop sending it new ones."""
        if dead and self._reliable is not None:
            # peer-death notice: the resubmit below IS the recovery;
            # retransmitting into a dead worker only delays it
            self._reliable.drop_target(worker)
        resubmit: List[TaskSpec] = []
        with self._lease_lock:
            try:
                self._lease_pool.remove(worker)
            except ValueError:
                pass
            if dead:
                self._lease_inflight.pop(worker, None)
                lost = [tid for tid, w in self._direct_tids.items()
                        if w == worker]
                for tid in lost:
                    del self._direct_tids[tid]
            else:
                lost = []
            if not self._lease_pool:
                self._lease_state = "none"
                self._lease_backoff_until = time.monotonic() + \
                    self._lease_backoff.next_delay()
                # no leases left: the local backlog would never drain
                while self._direct_backlog:
                    resubmit.append(self._pop_backlog_locked())
        with self._inflight_lock:
            for tid in lost:
                spec = self._inflight_specs.get(tid)
                if spec is not None:
                    resubmit.append(spec)
        for spec in resubmit:
            if self._owner_local:
                for oid in spec.return_ids():
                    self.reference_counter.promote(oid)
            self._send(P.SUBMIT_TASK, {"spec": spec})

    def _release_all_leases(self) -> None:
        with self._lease_lock:
            pool, self._lease_pool = self._lease_pool, []
            self._lease_state = "none"
            self._lease_inflight.clear()
            self._direct_tids.clear()
            backlog = list(self._direct_backlog)
            self._direct_backlog.clear()
            self._direct_backlog_bytes = 0
        for spec in backlog:
            if self._owner_local:
                for oid in spec.return_ids():
                    self.reference_counter.promote(oid)
            self._send(P.SUBMIT_TASK, {"spec": spec})
        if pool:
            try:
                self._send(P.RELEASE_LEASES, {"workers": pool})
            except Exception:
                pass

    # ------------------------------------------------- direct actor calls
    def _submit_actor_task(self, spec: TaskSpec) -> None:
        """Client-side actor submitter (reference:
        CoreWorkerDirectActorTaskSubmitter, direct_actor_task_submitter.h):
        queue until the actor's worker address resolves, then push calls
        directly to that worker — the controller is only consulted for the
        address (long-poll held until ALIVE) and for liveness pubsub."""
        aid = spec.actor_id.binary()
        action = None  # ("dead", err) | "resolve" | "queued" | "sent"
        with self._actors_lock:
            st = self._actors.get(aid)
            if st is None:
                st = self._actors[aid] = {
                    "state": "RESOLVING", "worker": None, "queue": [],
                    "inflight": {}, "error": None, "tmpls": {}}
                st["queue"].append(spec)
                action = "resolve"
            elif st["state"] == "DIRECT":
                st["inflight"][spec.task_id.binary()] = spec
                # enqueue INSIDE the lock: template registration and its
                # compact calls must hit the peer channel in assignment
                # order, or the worker sees a compact call it can't
                # expand
                self._send_direct(st["worker"], P.ACTOR_CALL,
                                  self._actor_call_msg(st, spec))
                action = "sent"
            elif st["state"] == "DEAD":
                action = ("dead", st["error"])
            else:  # RESOLVING
                st["queue"].append(spec)
                action = "queued"
        if action == "resolve":
            self._resolve_actor(aid)
        elif isinstance(action, tuple) and action[0] == "dead":
            self._fail_actor_task_local(spec, action[1])

    def _on_tmpl_miss(self, m: dict) -> None:
        """The actor worker lost the template for a compact call
        (evicted, or the registration message was dropped): resend that
        call with its FULL spec — which also re-registers the template
        for subsequent compact calls. Without this the dropped call
        would hang its ray.get forever."""
        tid_b = m.get("task_id") or b""
        with self._actors_lock:
            for st in self._actors.values():
                spec = st["inflight"].get(tid_b)
                if spec is not None and st["state"] == "DIRECT":
                    # the worker's view of our templates is stale: start
                    # a fresh numbering so every method re-registers,
                    # then resend this call full (which re-registers its
                    # own template in the same message)
                    st["tmpls"] = {}
                    self._send_direct(
                        st["worker"], P.ACTOR_CALL,
                        self._actor_call_msg(st, spec, keep_seq=True))
                    return

    def _actor_call_msg(self, st: dict, spec: TaskSpec,
                        keep_seq: bool = False) -> dict:
        """Wire form of one actor call. The spec is mostly static per
        method: ship it once as a TEMPLATE, then only the dynamic fields
        (reference: the submitter's push_normal_task payload is protobuf
        with the same static/dynamic split done by field encoding).
        Caller holds _actors_lock.

        Sequence numbers are assigned HERE, at send time, one monotonic
        stream per (this caller, actor incarnation) — reference:
        CoreWorkerDirectActorTaskSubmitter's seq_no. The actor-side
        sequencer (worker._CallSequencer) uses them to execute calls in
        submission order even when the reliable layer's retransmits
        deliver them out of order. ``keep_seq`` re-sends (TMPL_MISS)
        reuse the call's original seq: the worker dropped that compact
        call BEFORE sequencing, so the resend must fill its own slot —
        a fresh seq would leave a permanent gap."""
        if not keep_seq:
            st["seq"] = st.get("seq", 0) + 1
            spec.sequence_number = st["seq"]
        if spec.runtime_env or spec.resources:
            # rare per-call variability: don't template
            return {"spec": spec}
        key = (spec.function, spec.name, spec.num_returns,
               spec.max_retries, spec.retry_exceptions,
               spec.concurrency_group, spec.backpressure)
        tmpls = st["tmpls"]
        tid = tmpls.get(key)
        me = self.worker_id.binary()
        if tid is None:
            tid = tmpls[key] = len(tmpls) + 1
            return {"spec": spec, "tmpl": tid, "caller": me}
        return {"tmpl": tid, "caller": me,
                "task_id": spec.task_id.binary(),
                "seq": spec.sequence_number,
                "args_blob": spec.args_blob,
                "arg_refs": spec.arg_refs or None,
                "arg_metas": spec.arg_metas,
                # the template's trace is the FIRST call's — each
                # compact call must carry its own causal link
                "trace": spec.trace}

    def _resolve_actor(self, aid: bytes) -> None:
        hexid = ActorID(aid).hex()
        channel = f"actor:{hexid}"
        if channel not in self.pubsub_handlers:
            self.subscribe(channel,
                           lambda ch, data, aid=aid: self._on_actor_update(aid, data))
        rid = self.replies.new_request(
            callback=lambda reply, aid=aid: self._on_actor_addr(aid, reply))
        self._send(P.ACTOR_ADDR, {"actor_id": aid, "rid": rid})

    def _on_actor_addr(self, aid: bytes, reply: Any) -> None:
        """Pump-thread callback: the controller answered the address
        long-poll (actor ALIVE on some worker, or dead)."""
        to_send: List[TaskSpec] = []
        to_fail: List[TaskSpec] = []
        err = None
        worker = None
        with self._actors_lock:
            st = self._actors.get(aid)
            if st is None or st["state"] == "DEAD":
                return
            bad = not isinstance(reply, dict) or reply.get("__error__") \
                or reply.get("dead")
            if bad:
                from ray_tpu_torch.exceptions import ActorDiedError
                if isinstance(reply, dict) and reply.get("error"):
                    err = P.loads(reply["error"])
                else:
                    err = ActorDiedError(ActorID(aid), "actor is dead")
                st["state"] = "DEAD"
                st["error"] = err
                to_fail = st["queue"] + list(st["inflight"].values())
                st["queue"] = []
                st["inflight"] = {}
            else:
                worker = reply["worker"]
                st["state"] = "DIRECT"
                if worker != st["worker"]:
                    # a NEW incarnation: its executor state is fresh, so
                    # the seq stream restarts at 1 (the sequencer inits
                    # per-caller streams there). A same-worker re-resolve
                    # (controller restart) must keep the stream running.
                    st["seq"] = 0
                st["worker"] = worker
                st["tmpls"] = {}  # templates are per worker incarnation
                to_send = st["queue"]
                st["queue"] = []
                for s in to_send:
                    st["inflight"][s.task_id.binary()] = s
                    self._send_direct(worker, P.ACTOR_CALL,
                                      self._actor_call_msg(st, s))
        for s in to_fail:
            self._fail_actor_task_local(s, err)

    def _on_actor_update(self, aid: bytes, data: Any) -> None:
        """Actor liveness pubsub: flip the submitter state machine."""
        state = (data or {}).get("state")
        if state == "RESTARTING":
            to_fail: List[TaskSpec] = []
            need_resolve = False
            with self._actors_lock:
                st = self._actors.get(aid)
                if st is None or st["state"] == "DEAD":
                    return
                st["state"] = "RESOLVING"
                old_worker = st["worker"]
                st["worker"] = None
                # inflight calls may or may not have executed; resubmit only
                # those the user marked retriable (reference semantics:
                # max_task_retries>0 => at-least-once across restarts)
                retry = [s for s in st["inflight"].values()
                         if s.max_retries != 0]
                to_fail = [s for s in st["inflight"].values()
                           if s.max_retries == 0]
                st["inflight"] = {}
                st["queue"] = retry + st["queue"]
                need_resolve = True
            if old_worker is not None and self._reliable is not None:
                # calls in flight to the restarting incarnation are
                # resubmitted (or typed-failed) below: abandon their
                # retransmits to the old worker
                self._reliable.drop_target(old_worker)
            # the actor is NOT dead — calls that raced the restart and
            # are not retriable surface the typed "temporarily
            # unreachable" error (reference: ActorUnavailableError),
            # so callers can distinguish retry-me from gone-for-good
            from ray_tpu_torch.exceptions import ActorUnavailableError
            for s in to_fail:
                self._fail_actor_task_local(
                    s, ActorUnavailableError(
                        ActorID(aid),
                        "actor restarting; call not retriable "
                        "(max_task_retries=0)"))
            if need_resolve:
                self._resolve_actor(aid)
        elif state == "DEAD":
            from ray_tpu_torch.exceptions import ActorDiedError
            err = ActorDiedError(ActorID(aid), "actor died")
            with self._actors_lock:
                st = self._actors.get(aid)
                if st is None or st["state"] == "DEAD":
                    return
                st["state"] = "DEAD"
                st["error"] = err
                worker = st.get("worker")
                to_fail = st["queue"] + list(st["inflight"].values())
                st["queue"] = []
                st["inflight"] = {}
            if worker is not None and self._reliable is not None:
                # stop retransmitting queued calls into the dead actor's
                # worker — the local failure below is the recovery
                self._reliable.drop_target(worker)
            for s in to_fail:
                self._fail_actor_task_local(s, err)

    def _fail_actor_task_local(self, spec: TaskSpec, err) -> None:
        """The owner fails its own futures — and tells the controller,
        so tasks parked on these result objects fail fast with the
        actor's error instead of waiting on an object that will never
        exist (error propagation through the object graph)."""
        if spec.is_streaming:
            # streaming call: there are no static return objects — the
            # stream itself is the future to fail
            st = self._stream_for(spec.task_id.binary())
            if st is not None:
                st.fail(err)
                self._drop_stream(spec.task_id.binary())
            self._unpin_task_args(spec)
            return
        blob = P.dumps(err)
        results = []
        untracked = self.reference_counter._untracked
        for oid in spec.return_ids():
            b = oid.binary()
            meta = {"object_id": b, "error": blob}
            local = self._owner_local and b in untracked
            with self._meta_lock:
                self._meta[b] = meta
                if local:
                    # owner-local error object: nobody else can be parked
                    # on it (escape would have promoted it) — keep it out
                    # of the controller's directory. A later escape
                    # publishes the error meta like any owner-local value.
                    self._local_objects[b] = None
            self.memory_store.put(oid, _MetaReady(meta))
            if not local:
                results.append({"object_id": b})
        self._unpin_task_args(spec)
        try:
            self._send(P.TASK_DONE, {
                "task_id": spec.task_id.binary(),
                "trace": spec.trace,
                "results": results,
                "error": blob,
                "retriable": False,
                "owner": self.worker_id.binary(),
                "owner_notified": True,
                "is_actor_task": True,
                # sender is the OWNER, not the executing worker: the
                # controller must only record the error objects, never
                # run worker/lease bookkeeping against this identity
                "owner_report": True,
            })
        except Exception:
            pass

    def create_actor(self, spec: TaskSpec) -> None:
        spec.owner = self.worker_id
        if spec.trace is None:
            spec.trace = EV.child_trace(spec.task_id.hex())
        self.recorder.record_task(
            EV.SUBMITTED, spec.task_id.hex(), spec.trace,
            name=spec.name or spec.function.qualname, actor=True)
        self.request(P.CREATE_ACTOR, {"spec": spec})

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        tid_b = ref.id().task_id().binary()
        # direct actor call: in flight → cancel at the worker; still queued
        # client-side (address unresolved) → unqueue and fail locally (the
        # broker never saw the call, so CANCEL_TASK there would no-op and
        # the call would run anyway once the address arrived)
        worker = None
        queued_spec = None
        with self._actors_lock:
            for st in self._actors.values():
                if tid_b in st["inflight"]:
                    worker = st["worker"]
                    break
                for i, s in enumerate(st["queue"]):
                    if s.task_id.binary() == tid_b:
                        queued_spec = st["queue"].pop(i)
                        break
                if queued_spec is not None:
                    break
        if queued_spec is not None:
            from ray_tpu_torch.exceptions import TaskCancelledError
            self._fail_actor_task_local(
                queued_spec, TaskCancelledError(queued_spec.task_id))
            return
        if worker is not None:
            self._send_direct(worker, P.CANCEL_QUEUED,
                              {"task_id": tid_b, "force": force})
            return
        # driver-leased direct task: cancel at its worker (the
        # controller never saw it); backlogged → unqueue + fail locally
        with self._lease_lock:
            direct_worker = self._direct_tids.get(tid_b)
            backlogged = None
            if direct_worker is None:
                for i, s in enumerate(self._direct_backlog):
                    if s.task_id.binary() == tid_b:
                        backlogged = s
                        del self._direct_backlog[i]
                        self._direct_backlog_bytes -= \
                            len(s.args_blob) + 512
                        break
        if backlogged is not None:
            from ray_tpu_torch.exceptions import TaskCancelledError
            with self._inflight_lock:
                # never resubmit a cancelled task on RECONNECT
                self._inflight_specs.pop(tid_b, None)
            self._fail_actor_task_local(
                backlogged, TaskCancelledError(backlogged.task_id))
            return
        if direct_worker is not None:
            self._send_direct(direct_worker, P.CANCEL_QUEUED,
                              {"task_id": tid_b, "force": force})
            return
        self._send(P.CANCEL_TASK, {"task_id": tid_b, "force": force})

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._send(P.KILL_ACTOR, {"actor_id": actor_id.binary(),
                                  "no_restart": no_restart})

    # ------------------------------------------------------------ kv / pg
    def kv_put(self, key: bytes, value: bytes, ns: str = "",
               overwrite: bool = True) -> bool:
        return self.request(P.KV_OP, {"op": "put", "ns": ns, "key": key,
                                      "value": value, "overwrite": overwrite})["added"]

    def kv_get(self, key: bytes, ns: str = "") -> Optional[bytes]:
        return self.request(P.KV_OP, {"op": "get", "ns": ns, "key": key})["value"]

    def kv_del(self, key: bytes, ns: str = "") -> bool:
        return self.request(P.KV_OP, {"op": "del", "ns": ns, "key": key})["deleted"]

    def kv_exists(self, key: bytes, ns: str = "") -> bool:
        return self.request(P.KV_OP, {"op": "exists", "ns": ns, "key": key})["exists"]

    def kv_keys(self, prefix: bytes = b"", ns: str = "") -> List[bytes]:
        return self.request(P.KV_OP, {"op": "keys", "ns": ns, "prefix": prefix})["keys"]

    def state_query(self, what: str, **kw) -> Any:
        return self.request(P.STATE_QUERY, {"what": what, **kw})["rows"]

    # ----------------------------------------------------------- functions
    def export_function(self, key: str, blob: bytes) -> None:
        self.request(P.EXPORT_FUNCTION, {"key": key, "blob": blob})

    def fetch_function(self, key: str) -> Optional[bytes]:
        return self.request(P.FETCH_FUNCTION, {"key": key})["blob"]

    # ------------------------------------------------------------ timeline
    def _record_event(self, spec: TaskSpec, event: str) -> None:
        if not self.config.enable_timeline:
            return
        self._timeline_buf.append({
            "name": spec.name or spec.function.qualname, "cat": "task",
            "ph": "i", "ts": time.time() * 1e6, "pid": os.getpid(),
            "tid": threading.get_ident() % 1_000_000,
            "args": {"task_id": spec.task_id.hex(), "event": event}})
        if len(self._timeline_buf) >= 512:
            self.flush_timeline()

    def record_span(self, name: str, start_s: float, dur_s: float,
                    **args) -> None:
        self._timeline_buf.append({
            "name": name, "cat": "task", "ph": "X", "ts": start_s * 1e6,
            "dur": dur_s * 1e6, "pid": os.getpid(),
            "tid": threading.get_ident() % 1_000_000, "args": args})
        if len(self._timeline_buf) >= 512:
            self.flush_timeline()

    def flush_events(self) -> None:
        """Push buffered flight-recorder events to the controller now
        (state queries call this so fresh local events are visible)."""
        self.recorder.flush()

    def flush_timeline(self) -> None:
        if not self._timeline_buf:
            return
        buf, self._timeline_buf = self._timeline_buf, []
        try:
            self._send(P.TIMELINE_EVENTS, {"events": buf})
        except Exception:
            pass

    # ------------------------------------------------------------- pubsub
    def subscribe(self, channel: str, cb: Callable) -> None:
        self.pubsub_handlers.setdefault(channel, []).append(cb)
        self._send(P.SUBSCRIBE, {"channel": channel})

    def publish(self, channel: str, data: Any) -> None:
        self._send(P.PUBSUB, {"channel": channel, "data": data})


class _MetaReady:
    """Marker in the memory store: result meta arrived, value not yet
    materialized (lazy deserialization at first get)."""
    __slots__ = ("meta",)

    def __init__(self, meta: dict):
        self.meta = meta


def _weakref_targets(value, depth: int = 3) -> list:
    """Weakref-able objects inside ``value`` whose lifetime tracks the
    zero-copy buffers (numpy arrays and arbitrary user objects). Plain
    containers are walked shallowly; values with no weakref-able parts
    (pure bytes/str/scalars — which pickle COPIES out of the buffer
    anyway) return []."""
    out: list = []

    def walk(v, d):
        if d < 0:
            return
        tv = type(v)
        if tv in (int, float, str, bytes, bytearray, bool,
                  type(None)):
            return
        if tv is dict:
            for x in v.values():
                walk(x, d - 1)
            return
        if tv in (list, tuple, set, frozenset):
            for x in v:
                walk(x, d - 1)
            return
        try:
            import weakref
            weakref.ref(v)
        except TypeError:
            return
        out.append(v)

    walk(value, depth)
    return out
