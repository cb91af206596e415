"""Client-side of the client protocol.

Reference: ``python/ray/util/client/worker.py:81`` (``Worker`` — the
gRPC stub behind ``ray.init("ray://...")``) and ``api.py`` (the ClientAPI
that the public functions delegate to in client mode). Here
:class:`ClientWorker` is installed by ``ray_tpu_torch.init("ray://host:port")``;
``ray_tpu_torch.remote/get/put/...`` route to it while connected.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import zmq

from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.util.client import common as C
from ray_tpu_torch.util.client.common import (
    ClientActorHandle, ClientObjectRef)

_BLOCK_SLICE_S = C.BLOCK_SLICE_S

_UNSET = object()


class ClientRemoteFunction:
    """Client counterpart of RemoteFunction: lazily registered with the
    server on first use (ships the cloudpickled function once)."""

    def __init__(self, worker: "ClientWorker", func, options: dict):
        self._worker = worker
        self._func = func
        self._options = dict(options)
        self._fn_id: Optional[bytes] = None
        self.__name__ = getattr(func, "__name__", "anonymous")

    def options(self, **opts):
        merged = dict(self._options)
        merged.update(opts)
        out = ClientRemoteFunction(self._worker, self._func, merged)
        out._fn_id = self._fn_id  # per-call opts ride the CALL message
        out._call_opts = opts
        return out

    def remote(self, *args, **kwargs):
        if self._fn_id is None:
            self._fn_id = self._worker._register_fn(
                self._func, self._options)
        return self._worker._call_fn(
            self._fn_id, args, kwargs, getattr(self, "_call_opts", None))

    def __call__(self, *a, **kw):
        raise TypeError(
            "remote function cannot be called directly; use .remote()")


class ClientActorClass:
    def __init__(self, worker: "ClientWorker", cls, options: dict):
        self._worker = worker
        self._cls = cls
        self._options = dict(options)
        self._cls_id: Optional[bytes] = None
        self._methods: List[str] = []

    def options(self, **opts):
        merged = dict(self._options)
        merged.update(opts)
        out = ClientActorClass(self._worker, self._cls, merged)
        out._cls_id = self._cls_id
        out._methods = self._methods
        out._create_opts = opts
        return out

    def remote(self, *args, **kwargs):
        if self._cls_id is None:
            self._cls_id, self._methods = self._worker._register_class(
                self._cls, self._options)
        opts = getattr(self, "_create_opts", None)
        return self._worker._create_actor(
            self._cls_id, args, kwargs, opts, self._methods)


class ClientWorker:
    """Connection to a ClientServer; implements the public API surface."""

    def __init__(self, address: str, timeout: float = 30.0):
        # address: "ray://host:port"
        hostport = address[len("ray://"):] if address.startswith("ray://") \
            else address
        if ":" not in hostport:
            hostport = f"{hostport}:{C.DEFAULT_PORT}"
        self.address = hostport
        self.timeout = timeout
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.DEALER)
        self._sock.connect(f"tcp://{hostport}")
        self._lock = threading.Lock()   # one in-flight request at a time
        self._rid = 0
        self._closed = False
        # Deferred releases: __del__ may run on any thread, including one
        # already inside _request holding self._lock — so a release NEVER
        # does network I/O itself; it only appends here, and the list is
        # flushed as a piggyback on the next normal request (same pattern
        # as core.reference_counter._deferred_decrefs).
        self._release_lock = threading.Lock()
        self._pending_release: List[bytes] = []
        self._pending_release_actors: List[bytes] = []
        info = self._request({"op": "connect"})
        self.server_info = info

    # -------------------------------------------------------------- rpc
    def _request(self, req: dict, timeout: Any = _UNSET) -> dict:
        """One round-trip. ``timeout`` is the per-RPC reply deadline
        (default: the connection timeout); ``None`` waits forever.
        Blocking ops (get/wait) never need a long RPC deadline — the
        server clamps them to _BLOCK_SLICE_S and the caller re-polls."""
        if self._closed:
            raise ConnectionError("client connection is closed")
        timeout = self.timeout if timeout is _UNSET else timeout
        with self._lock:
            self._rid += 1
            req["rid"] = self._rid
            with self._release_lock:
                rel, self._pending_release = self._pending_release, []
                rel_a, self._pending_release_actors = \
                    self._pending_release_actors, []
            if rel:
                # piggyback deferred ref releases (no extra roundtrip)
                req["release"] = rel
            if rel_a:
                req["release_actors"] = rel_a
            self._sock.send(C.dumps(req))
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while True:
                if deadline is None:
                    wait_ms = 60000
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"client request {req['op']} timed out "
                            f"({timeout}s) against {self.address}")
                    wait_ms = max(1, int(remaining * 1000))
                if not self._sock.poll(wait_ms):
                    continue
                out = C.loads(self._sock.recv())
                if out.get("rid") == self._rid:
                    break
        if not out.get("ok"):
            err = out.get("error")
            raise C.loads(err) if err is not None else \
                ConnectionError("client request failed")
        return out

    def _release(self, ref_id: bytes) -> None:
        # called from __del__ on an arbitrary thread: append only —
        # any network I/O here can deadlock on self._lock (see ctor).
        if self._closed:
            return
        with self._release_lock:
            self._pending_release.append(ref_id)

    def _release_actor(self, actor_id: bytes) -> None:
        # also reached from ClientActorHandle.__del__: defer identically.
        if self._closed:
            return
        with self._release_lock:
            self._pending_release_actors.append(actor_id)

    # -------------------------------------------------------------- api
    def put(self, value: Any) -> ClientObjectRef:
        out = self._request({"op": "put", "value": C.dumps(value)})
        return ClientObjectRef(out["ref_id"], self)

    def get(self, refs, timeout: Optional[float] = None):
        """Blocks until the objects are ready (timeout=None means
        forever, matching the driver-side contract) by re-polling the
        server in _BLOCK_SLICE_S slices — no RPC ever outlives a slice,
        so a long-running task cannot trip the connection timeout."""
        single = isinstance(refs, ClientObjectRef)
        if single:
            refs = [refs]
        for r in refs:
            if not isinstance(r, ClientObjectRef):
                raise TypeError(f"expected ClientObjectRef, got {type(r)}")
        ids = [r.binary() for r in refs]
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            sl = _BLOCK_SLICE_S if deadline is None else \
                max(0.0, min(_BLOCK_SLICE_S,
                             deadline - time.monotonic()))
            # RPC deadline: the reply for a ready object includes its
            # serialized value, which can take arbitrarily long to build
            # and transfer for huge objects — so a user-unbounded get
            # gets an unbounded RPC too (contract: get(timeout=None)
            # blocks forever), while a bounded get allows the user's
            # whole remaining budget plus a transfer margin.
            rpc_t = None if timeout is None else \
                max(deadline - time.monotonic(), sl) + \
                max(self.timeout, _BLOCK_SLICE_S * 2)
            out = self._request({"op": "get", "ref_ids": ids,
                                 "timeout": sl}, timeout=rpc_t)
            if not out.get("pending"):
                vals = C.loads(out["values"])
                return vals[0] if single else vals
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(
                    f"ray.get timed out after {timeout}s waiting for "
                    f"{len(ids)} object(s)")

    def wait(self, refs: Sequence[ClientObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True
             ) -> Tuple[List[ClientObjectRef], List[ClientObjectRef]]:
        by_id = {r.binary(): r for r in refs}
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            sl = _BLOCK_SLICE_S if deadline is None else \
                max(0.0, min(_BLOCK_SLICE_S,
                             deadline - time.monotonic()))
            out = self._request(
                {"op": "wait", "ref_ids": list(by_id.keys()),
                 "num_returns": num_returns, "timeout": sl},
                timeout=sl + max(self.timeout, _BLOCK_SLICE_S * 2))
            if len(out["ready"]) >= num_returns or (
                    deadline is not None
                    and time.monotonic() >= deadline):
                return ([by_id[b] for b in out["ready"]],
                        [by_id[b] for b in out["pending"]])

    def remote(self, *args, **options):
        if len(args) == 1 and callable(args[0]) and not options:
            return self._wrap(args[0], {})
        def deco(obj):
            return self._wrap(obj, options)
        return deco

    def _wrap(self, obj, options: dict):
        if isinstance(obj, type):
            return ClientActorClass(self, obj, options)
        return ClientRemoteFunction(self, obj, options)

    def kill(self, actor: ClientActorHandle, *, no_restart: bool = True):
        self._request({"op": "kill_actor", "actor_id": actor._id,
                       "no_restart": no_restart})

    def cancel(self, ref: ClientObjectRef, *, force: bool = False):
        self._request({"op": "cancel", "ref_id": ref.binary(),
                       "force": force})

    def get_actor(self, name: str, namespace: str = "") -> ClientActorHandle:
        out = self._request({"op": "get_actor", "name": name,
                             "namespace": namespace})
        return ClientActorHandle(out["actor_id"], self, out["methods"])

    def cluster_resources(self) -> Dict[str, float]:
        return C.loads(self._request(
            {"op": "cluster_info", "kind": "resources"})["data"])

    def available_resources(self) -> Dict[str, float]:
        return C.loads(self._request(
            {"op": "cluster_info", "kind": "available"})["data"])

    def nodes(self) -> List[dict]:
        return C.loads(self._request(
            {"op": "cluster_info", "kind": "nodes"})["data"])

    # ---------------------------------------------------- fn/actor plumbing
    def _register_fn(self, func, options: dict) -> bytes:
        return self._request({"op": "register_fn", "func": C.dumps(func),
                              "options": options})["fn_id"]

    def _call_fn(self, fn_id: bytes, args, kwargs, options):
        out = self._request({
            "op": "call_fn", "fn_id": fn_id,
            "args": C.dumps((args, kwargs)), "options": options})
        refs = [ClientObjectRef(b, self) for b in out["ref_ids"]]
        return refs if out["many"] else refs[0]

    def _register_class(self, cls, options: dict):
        out = self._request({"op": "register_class", "cls": C.dumps(cls),
                             "options": options})
        return out["cls_id"], out["methods"]

    def _create_actor(self, cls_id: bytes, args, kwargs, options, methods):
        out = self._request({
            "op": "create_actor", "cls_id": cls_id,
            "args": C.dumps((args, kwargs)), "options": options})
        return ClientActorHandle(out["actor_id"], self, methods)

    def _call_method(self, actor_id: bytes, method: str, args, kwargs,
                     options):
        out = self._request({
            "op": "call_method", "actor_id": actor_id, "method": method,
            "args": C.dumps((args, kwargs)), "options": options or None})
        refs = [ClientObjectRef(b, self) for b in out["ref_ids"]]
        return refs if out["many"] else refs[0]

    def disconnect(self) -> None:
        if self._closed:
            return
        try:
            self._request({"op": "disconnect"}, timeout=5)
        except Exception:
            pass
        self._closed = True
        try:
            self._sock.close(0)
        except Exception:
            pass

    # duck-type used by api.shutdown
    def shutdown(self) -> None:
        self.disconnect()

    def is_connected(self) -> bool:
        return not self._closed


def connect(address: str, timeout: Optional[float] = None) -> ClientWorker:
    """Connect to a ClientServer; returns the installed ClientWorker.

    ``timeout`` is the per-RPC reply deadline (not a cap on how long
    get/wait may block — those re-poll in slices). Defaults to the
    RAY_TPU_TORCH_CLIENT_TIMEOUT env var, else 30s."""
    if timeout is None:
        timeout = float(os.environ.get("RAY_TPU_TORCH_CLIENT_TIMEOUT", "30"))
    return ClientWorker(address, timeout=timeout)
