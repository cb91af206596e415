"""Control-plane wire protocol over ZeroMQ.

Equivalent role to the reference's gRPC layer (``src/ray/rpc/``) plus the
protobuf schema (``src/ray/protobuf/``). Transport: one ROUTER socket bound
by the controller at ``ipc://<session>/controller.sock`` (or its abstract
twin, see :func:`unix_socket_name`); every other
process (driver, node managers, workers) connects a DEALER whose identity is
its binary WorkerID/NodeID. Messages are two frames: ``[type][payload]``
with the payload pickled (protocol 5). Request/response pairs carry a
correlation id; one-way notifications don't.

ZeroMQ gives the same properties the reference builds on asio+gRPC: ordered
per-peer delivery, async send queues, and broker routing by identity.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import struct
import threading
import time
from typing import Any, Dict, Optional

# ---- message types ----
# registration / lifecycle
REGISTER = b"REG"            # {kind, id, node_id, pid} -> {ok, session_info}
REGISTER_REPLY = b"REGR"
SHUTDOWN = b"BYE"
# tasks
SUBMIT_TASK = b"SUB"         # {spec}
SUBMIT_BATCH = b"SBB"        # {specs: [spec, ...]} — pipelined submission
TASK_ASSIGN = b"ASG"         # controller->node {spec}
TASK_DISPATCH = b"DSP"       # node->worker {spec}
TASK_DONE = b"DON"           # worker->controller {task_id, results, error}
TASK_RESULT = b"RES"         # controller->owner {object_id, inline|location|error}
CANCEL_TASK = b"CAN"
# actors
CREATE_ACTOR = b"CAC"
ACTOR_UPDATE = b"AUP"        # controller->subscribers {actor_id, state, ...}
SUBMIT_ACTOR_TASK = b"SAT"
KILL_ACTOR = b"KIL"
GET_ACTOR = b"GAC"           # lookup by name
ACTOR_ADDR = b"AAD"          # caller->controller {actor_id} -> {worker}|{dead}
                             # (long-poll: held until the actor is ALIVE)
ACTOR_CALL = b"ACL"          # caller->actor worker DIRECT {spec} or
                             # compact {tmpl, caller, task_id, seq, ...}
TMPL_MISS = b"TMS"           # worker->caller DIRECT {task_id, tmpl}:
                             # resend the call with its full spec (the
                             # template was evicted or its registration
                             # message was lost)
CANCEL_QUEUED = b"CQD"       # ->worker direct {task_id, force}
# blocked-worker protocol (reference: NotifyDirectCallTaskBlocked /
# NotifyUnblocked — a worker blocked in ray.get releases its cpu and
# returns its unstarted pipeline so the cluster can make progress)
NOTIFY_BLOCKED = b"NBK"      # worker->controller {task_id}
NOTIFY_UNBLOCKED = b"NUB"    # worker->controller {}
TASK_HANDBACK = b"HBK"       # worker->controller {specs: [...]}
# streaming generator tasks (reference: num_returns="streaming" +
# ReportGeneratorItemReturns, task_manager.cc — each yielded item is its
# own object, eagerly reported to the owner while the task still runs)
STREAM_ITEM = b"SIT"         # worker->owner DIRECT {task_id, index, meta,
                             # worker}: one yielded item's result meta
STREAM_EOF = b"SEF"          # worker->owner DIRECT {task_id, count,
                             # worker, error?}: the stream is complete
STREAM_CREDIT = b"SCR"       # owner->worker DIRECT {task_id, consumed}:
                             # cumulative consumer progress — opens the
                             # producer's backpressure window
# objects
PUT_OBJECT = b"PUT"          # seal notification {object_id, node_id, size, owner}
FREE_OBJECT = b"FRE"         # controller->node {object_id}
GET_LOCATION = b"LOC"        # {object_id} -> {node_id|None, inline|None}
FETCH_OBJECT = b"FOB"        # controller->owner {object_id}: publish this
                             # owner-local object's value (PUT_OBJECT) so a
                             # parked borrower/dep can resolve
PULL_OBJECT = b"PUL"         # controller->dest node: pull this object
PULL_REQUEST = b"PRQ"        # dest->src node DIRECT: stream it to me
PUSH_OBJECT = b"PSH"         # src->dest node DIRECT: chunked payload
PULL_FAILED = b"PLF"         # src->dest direct / dest->controller: pull failed
STORE_RPC = b"SRP"           # worker->node DIRECT {op, rid, ...}:
                             # make_room {bytes} -> {freed} |
                             # restore {object_id} -> {ok} — plasma's
                             # create-queue + restore requests analog
LOCATE_OBJECT = b"LOB"       # controller->node {object_id}: if your store
                             # holds it, announce it (repairs a directory
                             # hole left by a producer killed mid-report)
CHUNK_ACK = b"CAK"           # dest->src DIRECT: chunk received (flow control)
RECONNECT = b"RCN"           # controller->peer: re-register + re-announce
                             # (sent after a controller restart)
REF_DELTAS = b"RFD"          # {deltas: {bytes: int}}
# direct normal-task transport (reference: worker leases,
# direct_task_transport.h — the owner leases workers and pushes tasks
# peer-to-peer; the controller only grants/reclaims leases)
LEASE_WORKERS = b"LSW"       # driver->controller {count, rid} -> {workers}
RELEASE_LEASES = b"RLW"      # driver->controller {workers: [identity]}
LEASE_REVOKED = b"LRV"       # controller->driver {worker}: leased worker
                             # died — resubmit its in-flight tasks
LEASE_GRANT = b"LGR"         # controller->driver {workers}: deferred
                             # grant for a parked LEASE_WORKERS request
OWNER_FREE = b"OFR"          # owner->controller {object_ids: [bytes]}:
                             # owner already evicted these never-shared
                             # extents; drop metadata + node bookkeeping
# kv / functions
KV_OP = b"KVO"               # {op: put|get|del|keys|exists, ns, key, value}
EXPORT_FUNCTION = b"EXF"     # {key, blob}
FETCH_FUNCTION = b"FEF"      # {key} -> {blob}
# placement groups
CREATE_PG = b"CPG"
REMOVE_PG = b"RPG"
PG_UPDATE = b"PGU"
# cluster
HEARTBEAT = b"HBT"           # node->controller {node_id, available, total, stats}
WORKER_PINNED = b"WPN"       # controller->node {worker_identity}: hosts an actor
PING = b"PNG"                # driver->controller liveness poke: lets a
                             # restarted controller ask it to RECONNECT
NODE_UPDATE = b"NUP"
WORKER_EXIT = b"WEX"
STATE_QUERY = b"STQ"         # {what, filters} -> rows
PROFILE_SELF = b"PRF"        # controller->worker {rid, duration_s}:
                             # sample your own stacks (dashboard
                             # profiling; reference: reporter agent's
                             # py-spy endpoints)
PROFILE_RESULT = b"PRR"      # worker->controller {rid, collapsed, ...}
TIMELINE_EVENTS = b"TLE"     # worker->controller span/timeline batch
TASK_EVENTS = b"TEV"         # any->controller {events: [...]}: flight-
                             # recorder flush (core/events.py). Rides
                             # the reliable layer (exactly-once-effect)
                             # but is fire-and-forget for the producer —
                             # a flush never blocks task progress.
METRIC_REPORT = b"MRT"       # any->controller {origin, seq, ts,
                             # metrics}: periodic full metric snapshot
                             # (util/metrics.py::MetricsReporter) for
                             # the fleet metrics plane
                             # (core/metrics_plane.py). Reliable like
                             # TEV, fire-and-forget for the producer;
                             # stale in-flight reports are superseded
                             # (drop-oldest, counted).
REQUEST_SPANS = b"RSP"       # any->controller {request_id, part, seq,
                             # spans: [...]}: per-request trace span
                             # batch (serve/request_trace.py). Reliable
                             # like TEV, fire-and-forget for the
                             # producer; tail-sampled at the source so
                             # only slow/failed/1-in-N requests ship.
PUBSUB = b"PUB"              # {channel, data} fanout
SUBSCRIBE = b"SSC"           # {channel}
GENERIC_REPLY = b"RPL"
ERROR_REPLY = b"ERR"
MSG_BATCH = b"MBB"           # {msgs: [(mtype, payload), ...]} — wire batching
MSG_ACK = b"ACK"             # {acks: [(sender_tag, [(lo, hi), ...])]}:
                             # batched ack ranges for reliably-delivered
                             # one-way messages (core/reliable.py). Never
                             # itself tracked — a lost ack just costs one
                             # deduped retransmit.

_DUMPS_PROTO = 5


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=_DUMPS_PROTO)


def loads(data: bytes) -> Any:
    return pickle.loads(data)


def wire_sizeof(obj: Any) -> int:
    """Wire footprint of ``obj`` as the runtime would actually ship it:
    pickle-5 meta plus the out-of-band buffers the zero-copy serializer
    strips (``core/serialization.py``). Large numpy arrays and tensors are
    counted at their raw buffer size instead of being copied through a
    flat pickle — this is the accounting the disagg KV hand-off reports
    as ``serve_kv_ship_bytes_total``."""
    try:
        from ray_tpu_torch.core.serialization import default_context
        return int(default_context().serialize(obj).total_bytes())
    except Exception:
        return len(dumps(obj))


class ReplyWaiter:
    """Correlates request/reply over the async socket pump.

    Two modes per request: blocking (``new_request()`` + ``wait()``) and
    callback (``new_request(callback=...)``) — the callback runs on the
    pump thread when the reply lands, so it must not block (reference:
    the ClientCallManager completion-queue callbacks, rpc/client_call.h).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: Dict[bytes, threading.Event] = {}
        self._replies: Dict[bytes, Any] = {}
        self._callbacks: Dict[bytes, Any] = {}

    _rid_counter = itertools.count(1)

    def new_request(self, callback=None) -> bytes:
        # rids only need per-process uniqueness (replies are routed by peer
        # identity); a counter avoids a urandom syscall per RPC
        rid = struct.pack("<QQ", os.getpid(), next(self._rid_counter))
        with self._lock:
            if callback is not None:
                self._callbacks[rid] = callback
            else:
                self._events[rid] = threading.Event()
        return rid

    def fulfill(self, rid: bytes, reply: Any) -> bool:
        with self._lock:
            cb = self._callbacks.pop(rid, None)
            if cb is None:
                ev = self._events.get(rid)
                if ev is None:
                    return False
                self._replies[rid] = reply
        if cb is not None:
            cb(reply)
            return True
        ev.set()
        return True

    def wait(self, rid: bytes, timeout: Optional[float],
             mtype: Optional[bytes] = None) -> Any:
        started = time.monotonic()
        with self._lock:
            ev = self._events[rid]
        if not ev.wait(timeout):
            with self._lock:
                self._events.pop(rid, None)
            from ray_tpu_torch.exceptions import RpcTimeoutError
            raise RpcTimeoutError(mtype, time.monotonic() - started)
        with self._lock:
            self._events.pop(rid, None)
            return self._replies.pop(rid)


#: longest path a unix socket address holds (``sun_path``: 108 bytes with
#: its NUL)
_UNIX_PATH_MAX = 107


def unix_socket_name(session_dir: str, name: str) -> str:
    """The session's unix socket ``name``: its file in the session dir, or,
    where that path is too long for a unix socket address (a long temp
    dir), a name in Linux's abstract namespace, written ``@...`` as zmq
    writes it and keyed by a digest of the session dir. An abstract name
    has no file and goes with its socket, so the session still keeps
    everything it makes under its own dir."""
    path = os.path.join(session_dir, name)
    if len(os.fsencode(path)) <= _UNIX_PATH_MAX:
        return path
    digest = hashlib.sha256(
        os.fsencode(os.path.abspath(session_dir))).hexdigest()[:32]
    return f"@raytorch-{digest}/{name}"


def unix_address(name: str) -> str:
    """A :func:`unix_socket_name` as the ``socket`` module binds it."""
    return "\0" + name[1:] if name.startswith("@") else name


def is_abstract(name: str) -> bool:
    return name.startswith("@")


def socket_path(session_dir: str) -> str:
    return "ipc://" + unix_socket_name(session_dir, "controller.sock")
