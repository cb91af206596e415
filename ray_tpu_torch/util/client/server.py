"""Client server: hosts a proxy driver for remote clients.

Reference: ``python/ray/util/client/server/server.py`` (RayletServicer —
per-client object/actor leases, function cache, disconnect GC). The
server runs inside a process that is already a cluster driver (head
node, or ``ray-tpu client-server``); each connected client gets its own
reference table so a disconnect releases exactly its leases.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import zmq

from ray_tpu_torch.util.client import common as C

logger = logging.getLogger(__name__)

#: Hard cap on how long a single get/wait handler may block, regardless
#: of the client-requested timeout. Clients re-poll (worker.py loops in
#: the same slice), so one never-ready object can't pin a handler slot
#: for unbounded time. Defined in common.py: both sides must agree.
_BLOCK_SLICE_S = C.BLOCK_SLICE_S


class _ClientSession:
    def __init__(self):
        self.refs: Dict[bytes, Any] = {}      # ref_id -> ObjectRef
        self.actors: Dict[bytes, Any] = {}    # actor_ref_id -> handle
        self.functions: Dict[bytes, Any] = {} # fn_id -> RemoteFunction
        self.classes: Dict[bytes, Any] = {}   # cls_id -> ActorClass
        self.last_seen = time.monotonic()
        #: ops currently executing on the handler pool — the idle reaper
        #: must never drop a session mid-operation (handlers run
        #: concurrently with the loop thread since the pool landed)
        self.inflight = 0


class ClientServer:
    """Serves the client protocol on a TCP ROUTER socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = C.DEFAULT_PORT,
                 idle_disconnect_s: float = 120.0, num_handlers: int = 8):
        # Default bind is loopback: the protocol deserializes pickled
        # payloads (arbitrary code execution by design, same trust model
        # as the reference's ray://). Exposing it beyond the machine is
        # an explicit operator opt-in (host="0.0.0.0") for trusted
        # networks only.
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            raise RuntimeError(
                "ClientServer must run inside an initialized driver "
                "(call ray_tpu_torch.init() first)")
        self._ray = ray_tpu_torch
        self.host = host
        self.port = port
        self.idle_disconnect_s = idle_disconnect_s
        self._sessions: Dict[bytes, _ClientSession] = {}
        self._sessions_lock = threading.Lock()
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.ROUTER)
        self._sock.bind(f"tcp://{host}:{port}")
        # port 0 takes a free port: the one bound is what clients dial
        self.port = int(self._sock.getsockopt_string(
            zmq.LAST_ENDPOINT).rsplit(":", 1)[1])
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="client-server", daemon=True)
        # Ops run on a pool so one slow client (big arg deserialization,
        # a get that has to pull a large object) can't stall every other
        # connection. Replies funnel back to the loop thread via a queue
        # + inproc wake socket: the ROUTER socket stays single-threaded.
        self._pool = ThreadPoolExecutor(
            max_workers=num_handlers, thread_name_prefix="client-op")
        self._reply_q: "queue.Queue[tuple]" = queue.Queue()
        self._wake_addr = f"inproc://client-server-wake-{id(self):x}"
        self._wake_pull = self._ctx.socket(zmq.PULL)
        self._wake_pull.bind(self._wake_addr)
        self._tls = threading.local()
        self._ref_seq = 0
        self._ref_seq_lock = threading.Lock()

    def start(self) -> "ClientServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3)
        self._pool.shutdown(wait=False)
        for s in (self._sock, self._wake_pull):
            try:
                s.close(0)
            except Exception:
                pass

    # ------------------------------------------------------------- loop
    def _loop(self) -> None:
        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        poller.register(self._wake_pull, zmq.POLLIN)
        last_reap = time.monotonic()
        while not self._stop.is_set():
            events = dict(poller.poll(timeout=250))
            if self._wake_pull in events:
                while self._wake_pull.poll(0):
                    self._wake_pull.recv()
            self._drain_replies()
            if self._sock not in events:
                # reap only on idle polls, and only after every received
                # message has bumped its session's last_seen below — a
                # request sitting in the recv or pool queue must never
                # lose its session to the reaper
                if time.monotonic() - last_reap > 10.0:
                    self._reap_idle()
                    last_reap = time.monotonic()
                continue
            while self._sock.poll(0):
                frames = self._sock.recv_multipart()
                identity, payload = frames[0], frames[-1]
                try:
                    req = C.loads(payload)
                except Exception as e:  # noqa: BLE001
                    self._reply(identity, {"ok": False,
                                           "error": C.dumps(e)})
                    continue
                # touch the session on the loop thread BEFORE handing to
                # the pool: protects it from the reaper while queued
                self._session(identity)
                self._pool.submit(self._handle, identity, req)

    def _handle(self, identity: bytes, req: dict) -> None:
        session = self._session(identity)
        with self._sessions_lock:
            session.inflight += 1
        try:
            out = self._dispatch(identity, req, session)
        except BaseException as e:  # noqa: BLE001
            logger.debug("client op %s failed", req.get("op"),
                         exc_info=True)
            out = {"ok": False, "error": C.dumps(e)}
        finally:
            with self._sessions_lock:
                session.inflight -= 1
                session.last_seen = time.monotonic()
        out["rid"] = req.get("rid")
        self._reply(identity, out)

    def _drain_replies(self) -> None:
        while True:
            try:
                identity, blob = self._reply_q.get_nowait()
            except queue.Empty:
                return
            try:
                self._sock.send_multipart([identity, blob])
            except Exception:
                pass

    def _reply(self, identity: bytes, out: dict) -> None:
        self._reply_q.put((identity, C.dumps(out)))
        if threading.current_thread() is self._thread:
            self._drain_replies()
        else:
            self._wake()

    def _wake(self) -> None:
        push = getattr(self._tls, "push", None)
        if push is None:
            push = self._ctx.socket(zmq.PUSH)
            push.connect(self._wake_addr)
            self._tls.push = push
        try:
            push.send(b"", zmq.DONTWAIT)
        except Exception:
            pass

    def _session(self, identity: bytes) -> _ClientSession:
        with self._sessions_lock:
            s = self._sessions.get(identity)
            if s is None:
                s = self._sessions[identity] = _ClientSession()
            s.last_seen = time.monotonic()
            return s

    def _reap_idle(self) -> None:
        now = time.monotonic()
        with self._sessions_lock:
            idle = [i for i, s in self._sessions.items()
                    if s.inflight == 0
                    and now - s.last_seen > self.idle_disconnect_s]
        for identity in idle:
            logger.info("client %s idle; releasing refs",
                        identity.hex()[:8])
            self._drop_session(identity)

    def _drop_session(self, identity: bytes) -> None:
        with self._sessions_lock:
            s = self._sessions.pop(identity, None)
        if s is None:
            return
        s.refs.clear()
        for h in s.actors.values():
            # only detached/named actors survive their creating client
            try:
                if not getattr(h, "_detached", False):
                    self._ray.kill(h)
            except Exception:
                pass
        s.actors.clear()

    def _mint(self) -> bytes:
        with self._ref_seq_lock:
            self._ref_seq += 1
            seq = self._ref_seq
        return os.urandom(12) + seq.to_bytes(4, "little")

    # -------------------------------------------------------- marshaling
    def _resolve_markers(self, session: _ClientSession, obj):
        """Replace _RefMarker instances (from pickled ClientObjectRefs)
        with the server-held ObjectRefs, recursively through the common
        containers (same depth the reference's marker pass covers)."""
        if isinstance(obj, C._RefMarker):
            ref = session.refs.get(obj.ref_id)
            if ref is None:
                raise KeyError(
                    f"client ref {obj.ref_id.hex()[:12]} is not leased "
                    f"to this connection")
            return ref
        if isinstance(obj, (list, tuple)):
            vals = [self._resolve_markers(session, v) for v in obj]
            return type(obj)(vals) if not isinstance(obj, tuple) \
                else tuple(vals)
        if isinstance(obj, dict):
            return {k: self._resolve_markers(session, v)
                    for k, v in obj.items()}
        return obj

    def _lease_ref(self, session: _ClientSession, ref) -> bytes:
        rid = self._mint()
        session.refs[rid] = ref
        return rid

    # --------------------------------------------------------- dispatch
    def _dispatch(self, identity: bytes, req: dict,
                  session: _ClientSession) -> dict:
        op = req["op"]
        for rid in req.get("release") or ():
            session.refs.pop(rid, None)
        for aid in req.get("release_actors") or ():
            session.actors.pop(aid, None)
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown client op {op!r}")
        return handler(session, req)

    def _op_connect(self, session, req) -> dict:
        with self._sessions_lock:
            n = len(self._sessions)
        info = {
            "ok": True,
            "num_clients": n,
            "resources": self._ray.cluster_resources(),
        }
        return info

    def _op_disconnect(self, session, req) -> dict:
        # release happens via identity lookup in _drop_session
        with self._sessions_lock:
            idents = [i for i, s in self._sessions.items() if s is session]
        for identity in idents:
            self._drop_session(identity)
        return {"ok": True}

    def _op_put(self, session, req) -> dict:
        value = self._resolve_markers(session, C.loads(req["value"]))
        ref = self._ray.put(value)
        return {"ok": True, "ref_id": self._lease_ref(session, ref)}

    @staticmethod
    def _clamp(timeout) -> float:
        # never let a client-supplied timeout (or None) hold a handler
        # slot longer than one slice; the client loops (worker.py get/wait)
        return _BLOCK_SLICE_S if timeout is None \
            else max(0.0, min(float(timeout), _BLOCK_SLICE_S))

    def _op_get(self, session, req) -> dict:
        refs = [session.refs[rid] for rid in req["ref_ids"]]
        uniq = list(dict.fromkeys(refs))
        ready, _ = self._ray.wait(
            uniq, num_returns=len(uniq),
            timeout=self._clamp(req.get("timeout")))
        if len(ready) < len(uniq):
            return {"ok": True, "pending": True}
        vals = self._ray.get(refs)
        return {"ok": True, "values": C.dumps(vals)}

    def _op_wait(self, session, req) -> dict:
        by_id = {session.refs[rid]: rid for rid in req["ref_ids"]}
        ready, pending = self._ray.wait(
            list(by_id.keys()), num_returns=req.get("num_returns", 1),
            timeout=self._clamp(req.get("timeout")))
        return {"ok": True,
                "ready": [by_id[r] for r in ready],
                "pending": [by_id[r] for r in pending]}

    def _op_release(self, session, req) -> dict:
        for rid in req["ref_ids"]:
            session.refs.pop(rid, None)
        return {"ok": True}

    def _op_release_actor(self, session, req) -> dict:
        session.actors.pop(req["actor_id"], None)
        return {"ok": True}

    def _op_register_fn(self, session, req) -> dict:
        fn = C.loads(req["func"])
        opts = req.get("options") or {}
        fn_id = self._mint()
        session.functions[fn_id] = self._ray.remote(**opts)(fn) \
            if opts else self._ray.remote(fn)
        return {"ok": True, "fn_id": fn_id}

    def _op_call_fn(self, session, req) -> dict:
        rf = session.functions[req["fn_id"]]
        if req.get("options"):
            rf = rf.options(**req["options"])
        args, kwargs = self._resolve_markers(
            session, C.loads(req["args"]))
        refs = rf.remote(*args, **kwargs)
        many = isinstance(refs, list)
        out = [self._lease_ref(session, r)
               for r in (refs if many else [refs])]
        return {"ok": True, "ref_ids": out, "many": many}

    def _op_register_class(self, session, req) -> dict:
        cls = C.loads(req["cls"])
        opts = req.get("options") or {}
        cls_id = self._mint()
        session.classes[cls_id] = self._ray.remote(**opts)(cls) \
            if opts else self._ray.remote(cls)
        methods = [n for n in dir(cls)
                   if not n.startswith("_") and callable(getattr(cls, n))]
        return {"ok": True, "cls_id": cls_id, "methods": methods}

    def _op_create_actor(self, session, req) -> dict:
        ac = session.classes[req["cls_id"]]
        opts = req.get("options") or {}
        if opts:
            ac = ac.options(**opts)
        args, kwargs = self._resolve_markers(
            session, C.loads(req["args"]))
        handle = ac.remote(*args, **kwargs)
        if opts.get("lifetime") == "detached" or opts.get("name"):
            handle._detached = True
        aid = self._mint()
        session.actors[aid] = handle
        return {"ok": True, "actor_id": aid}

    def _op_call_method(self, session, req) -> dict:
        handle = session.actors[req["actor_id"]]
        method = getattr(handle, req["method"])
        if req.get("options"):
            method = method.options(**req["options"])
        args, kwargs = self._resolve_markers(
            session, C.loads(req["args"]))
        refs = method.remote(*args, **kwargs)
        many = isinstance(refs, list)
        out = [self._lease_ref(session, r)
               for r in (refs if many else [refs])]
        return {"ok": True, "ref_ids": out, "many": many}

    def _op_get_actor(self, session, req) -> dict:
        handle = self._ray.get_actor(
            req["name"], namespace=req.get("namespace", ""))
        handle._detached = True   # named: outlives this client
        methods = [n for n in dir(handle)
                   if not n.startswith("_")]
        aid = self._mint()
        session.actors[aid] = handle
        # handle exposes methods dynamically; ask the actor class
        return {"ok": True, "actor_id": aid,
                "methods": getattr(handle, "_method_names", methods)}

    def _op_kill_actor(self, session, req) -> dict:
        handle = session.actors.get(req["actor_id"])
        if handle is not None:
            self._ray.kill(handle, no_restart=req.get("no_restart", True))
        return {"ok": True}

    def _op_cancel(self, session, req) -> dict:
        ref = session.refs.get(req["ref_id"])
        if ref is not None:
            self._ray.cancel(ref, force=req.get("force", False))
        return {"ok": True}

    def _op_cluster_info(self, session, req) -> dict:
        kind = req.get("kind", "resources")
        if kind == "resources":
            data = self._ray.cluster_resources()
        elif kind == "available":
            data = self._ray.available_resources()
        elif kind == "nodes":
            data = self._ray.nodes()
        else:
            raise ValueError(f"unknown cluster_info kind {kind!r}")
        return {"ok": True, "data": C.dumps(data)}
