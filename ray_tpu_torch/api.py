"""Public API: init/shutdown/remote/get/put/wait/....

Equivalent of the reference's ``python/ray/_private/worker.py`` public
surface (``init`` :1219, ``get`` :2561, ``put`` :2679, ``wait`` :2744,
``get_actor`` :2890, ``remote`` :3137) and the bootstrap logic of
``python/ray/_private/node.py`` / ``services.py`` — for the default
single-node ``init()`` the controller and node manager run as threads in
the driver process, workers as subprocesses; multi-node clusters connect
additional node-manager processes to the same controller socket.
"""

from __future__ import annotations

import atexit
import inspect
import json
import logging
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core.config import Config, get_config, set_config
from ray_tpu_torch.core.global_state import (
    global_worker, set_global_worker, try_global_worker)
from ray_tpu_torch.core.ids import ActorID, NodeID
from ray_tpu_torch.core.object_ref import ObjectRef

_head = None  # _HeadProcess for the in-process controller+node
_log_monitor = None
_client = None  # ClientWorker when connected via ray:// (client mode)


def _client_or_none():
    return _client if _client is not None and _client.is_connected() \
        else None


class _HeadProcess:
    def __init__(self, session_dir: str, config: Config,
                 resources: Dict[str, float], labels: Dict[str, str],
                 num_initial_workers: int):
        from ray_tpu_torch.core.controller import Controller
        from ray_tpu_torch.core.node import NodeManager
        self.session_dir = session_dir
        self.controller = Controller(session_dir, config)
        self.controller.start()
        self.node = NodeManager(session_dir, resources, labels=labels,
                                num_initial_workers=num_initial_workers,
                                config=config)
        self.node.start()
        self.dashboard = None
        if config.dashboard_enabled:
            try:
                from ray_tpu_torch.dashboard.head import DashboardHead
                self.dashboard = DashboardHead(
                    session_dir, self.controller,
                    port=config.dashboard_port)
            except Exception:
                logging.getLogger(__name__).exception(
                    "dashboard failed to start; continuing without it")

    def stop(self):
        try:
            if self.dashboard is not None:
                self.dashboard.stop()
        except Exception:
            pass
        try:
            self.node.stop()
        finally:
            self.controller.stop()


def session_root() -> str:
    """Where sessions live: ``ray_tpu_torch/`` in the temp dir (the JAX
    package's sessions live in ``/tmp/ray_tpu``, so the two never share
    one). Where the temp dir's path is too long for a unix socket, the
    session's sockets take abstract names
    (:func:`core.protocol.unix_socket_name`); the session dir stays here."""
    import tempfile
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def init(address: Optional[str] = None,
         *,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         labels: Optional[Dict[str, str]] = None,
         object_store_memory: Optional[int] = None,
         namespace: str = "",
         ignore_reinit_error: bool = False,
         log_to_driver: bool = True,
         _system_config: Optional[Dict[str, Any]] = None,
         _num_initial_workers: Optional[int] = None,
         _session_dir: Optional[str] = None) -> Dict[str, Any]:
    """Start a cluster in-process (or connect to one via ``address``).

    ``address="ray://host:port"`` enters client mode (reference: Ray
    Client, ``python/ray/util/client/worker.py:81``): no local runtime is
    started; the public API proxies to a remote cluster's client server.
    """
    global _head, _client
    if address is None:
        # `ray-tpu submit` / external drivers point here via env var
        # (reference analog: RAY_ADDRESS).
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
    if address and address.startswith("ray://"):
        if _client is not None and _client.is_connected():
            if ignore_reinit_error:
                return {}
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(use ignore_reinit_error=True)")
        from ray_tpu_torch.util.client import connect as _client_connect
        _client = _client_connect(address)
        atexit.register(_atexit_shutdown)
        return {"client": True, "address": address,
                **{k: v for k, v in _client.server_info.items()
                   if k != "ok"}}
    if try_global_worker() is not None:
        if ignore_reinit_error:
            return {}
        raise RuntimeError("ray_tpu_torch.init() called twice "
                           "(use ignore_reinit_error=True)")
    config = Config()
    if object_store_memory:
        config.object_store_memory = int(object_store_memory)
    config.apply_system_config(_system_config or {})
    set_config(config)

    from ray_tpu_torch.core.node import detect_resources
    from ray_tpu_torch.core.runtime import Runtime

    if address and address != "local":
        session_dir = address
    else:
        session_dir = _session_dir or os.path.join(
            session_root(),
            f"session_{int(time.time())}_{uuid.uuid4().hex[:8]}")
        os.makedirs(os.path.join(session_dir, "logs"), exist_ok=True)
        config.session_dir = session_dir
        res = detect_resources(num_cpus, num_gpus, resources)
        if _num_initial_workers is None:
            _num_initial_workers = min(int(res.get("CPU", 1)), 4)
        _head = _HeadProcess(session_dir, config, res, labels or {},
                             _num_initial_workers)
        with open(os.path.join(session_dir, "session.json"), "w") as f:
            json.dump({"shm_session": _head.node.shm_session,
                       "node_id": _head.node.node_id.hex()}, f)

    with open(os.path.join(session_dir, "session.json")) as f:
        session_info = json.load(f)
    runtime = Runtime("driver", session_dir,
                      NodeID.from_hex(session_info["node_id"]),
                      shm_session=session_info["shm_session"])
    runtime.namespace = namespace
    set_global_worker(runtime)
    reply = runtime.register()
    global _log_monitor
    if log_to_driver:
        from ray_tpu_torch.core.log_monitor import LogMonitor
        _log_monitor = LogMonitor(session_dir)
        _log_monitor.start()
    atexit.register(_atexit_shutdown)
    return {"session_dir": session_dir, "job_id": runtime.job_id.hex()}


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown() -> None:
    global _head, _log_monitor, _client
    if _client is not None:
        try:
            _client.disconnect()
        except Exception:
            pass
        _client = None
    if _log_monitor is not None:
        try:
            _log_monitor.stop()
        except Exception:
            pass
        _log_monitor = None
    w = try_global_worker()
    if w is not None:
        try:
            w.shutdown()
        except Exception:
            pass
        set_global_worker(None)
    if _head is not None:
        head, _head = _head, None
        head.stop()


def is_initialized() -> bool:
    return try_global_worker() is not None or _client_or_none() is not None


def remote(*args, **options):
    """``@remote`` decorator for functions and classes (reference:
    ``worker.py:3137``)."""
    c = _client_or_none()
    if c is not None:
        return c.remote(*args, **options)
    from ray_tpu_torch.actor import ActorClass
    from ray_tpu_torch.remote_function import RemoteFunction

    def make(target):
        if inspect.isclass(target):
            return ActorClass(target, **options)
        return RemoteFunction(target, **options)

    if len(args) == 1 and callable(args[0]) and not options:
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return make


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    # a value that resolves in this process (a compiled DAG's channel
    # result; a stand-in ref in serve's router tests) is accepted, as a
    # scalar or in a list
    if hasattr(refs, "__dag_local_value__"):
        return refs.__dag_local_value__(timeout)
    if isinstance(refs, (list, tuple)) and any(
            hasattr(r, "__dag_local_value__") for r in refs):
        return [get(r, timeout=timeout) for r in refs]
    c = _client_or_none()
    if c is not None:
        return c.get(refs, timeout=timeout)
    return global_worker().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    c = _client_or_none()
    if c is not None:
        return c.put(value)
    return global_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    c = _client_or_none()
    if c is not None:
        return c.wait(refs, num_returns=num_returns, timeout=timeout,
                      fetch_local=fetch_local)
    return global_worker().wait(refs, num_returns=num_returns,
                                timeout=timeout, fetch_local=fetch_local)


def kill(actor, *, no_restart: bool = True) -> None:
    c = _client_or_none()
    if c is not None:
        return c.kill(actor, no_restart=no_restart)
    global_worker().kill_actor(actor._id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    c = _client_or_none()
    if c is not None:
        return c.cancel(ref, force=force)
    global_worker().cancel(ref, force=force)


def get_actor(name: str, namespace: str = ""):
    c = _client_or_none()
    if c is not None:
        return c.get_actor(name, namespace=namespace)
    from ray_tpu_torch.actor import ActorHandle
    from ray_tpu_torch.core import protocol as P
    w = global_worker()
    reply = w.request(P.GET_ACTOR, {"name": name, "namespace": namespace})
    return ActorHandle(ActorID(reply["actor_id"]),
                       reply["spec_meta"]["qualname"])


def nodes() -> List[dict]:
    c = _client_or_none()
    if c is not None:
        return c.nodes()
    return global_worker().state_query("nodes")


def cluster_resources() -> Dict[str, float]:
    c = _client_or_none()
    if c is not None:
        return c.cluster_resources()
    return global_worker().state_query("cluster_resources")


def available_resources() -> Dict[str, float]:
    c = _client_or_none()
    if c is not None:
        return c.available_resources()
    return global_worker().state_query("available_resources")


def get_runtime_context():
    from ray_tpu_torch.runtime_context import get_runtime_context as _grc
    return _grc()


def method(**opts):
    from ray_tpu_torch.actor import method as _method
    return _method(**opts)


def timeline(filename: Optional[str] = None):
    """Dump the task timeline as a Chrome trace (reference:
    ``ray timeline`` / GcsTaskManager events)."""
    w = global_worker()
    w.flush_timeline()
    events = w.state_query("timeline")
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
        return filename
    return events
