"""serve.run / serve.start / serve.shutdown — the public entry points.

Reference: ``python/ray/serve/api.py`` (``serve.run`` :522). The
controller is a named singleton actor; ``run`` walks the bound app DAG
depth-first, deploying inner deployments first and substituting their
DeploymentHandles into outer constructor args (model composition).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve._private.controller import (
    CONTROLLER_NAME, ServeController)

_proxy_actor = None
_proxy_actors: Dict[str, Any] = {}   # node id hex -> proxy actor
_grpc_proxy_actor = None


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        cls = ray_tpu_torch.remote(num_cpus=0.5, name=CONTROLLER_NAME,
                             lifetime="detached",
                             max_concurrency=16)(ServeController)
        return cls.remote()


def _controller_or_none():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return None


def run(target: Application, *, name: str = "default",
        route_prefix: Optional[str] = "/", blocking: bool = False,
        _local_testing_mode: bool = False) -> DeploymentHandle:
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError(
            "serve.run expects a bound deployment (use .bind())")
    controller = _get_or_create_controller()

    apps: Dict[str, Application] = {}
    target._collect(apps)  # topological: dependencies first

    handles: Dict[str, DeploymentHandle] = {}
    for dep_name, app in apps.items():
        def sub(v):
            if isinstance(v, Application):
                return handles[v.deployment.name]
            return v
        init_args = tuple(sub(a) for a in app.init_args)
        init_kwargs = {k: sub(v) for k, v in app.init_kwargs.items()}
        is_ingress = dep_name == target.deployment.name
        ray_tpu_torch.get(controller.deploy.remote(
            dep_name, app.deployment, init_args, init_kwargs,
            route_prefix if is_ingress else None,
            name if is_ingress else None))
        handles[dep_name] = DeploymentHandle(dep_name, controller)

    handle = handles[target.deployment.name]
    if blocking:  # pragma: no cover - interactive use
        while True:
            time.sleep(1)
    return handle


def start(http_options: Optional[Dict[str, Any]] = None,
          grpc_options: Optional[Dict[str, Any]] = None,
          **kwargs) -> None:
    """Start the ingress proxies (reference ``serve.start``). HTTP
    starts when ``http_options`` is given or when neither option is
    given (legacy default); gRPC starts only when ``grpc_options`` is
    given — a gRPC-only start must not grab the default HTTP port.

    One HTTP proxy runs on EVERY alive node (reference: proxy-per-node
    behind ProxyRouter) unless ``http_options={"location": "HeadOnly"}``.
    On a real pod each node binds the same configured port; when several
    nodes share one host (tests), secondary proxies take ephemeral
    ports — ``proxy_addresses()`` lists them all."""
    global _proxy_actor, _grpc_proxy_actor
    want_http = http_options is not None or grpc_options is None
    http_options = http_options or {}
    controller = _get_or_create_controller()
    if want_http and _proxy_actor is None:
        from ray_tpu_torch.serve._private.proxy import HTTPProxy
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        host = http_options.get("host", "127.0.0.1")
        port = http_options.get("port", 8000)
        location = http_options.get("location", "EveryNode")
        nodes = [n for n in ray_tpu_torch.nodes() if n.get("alive")]
        local_hex = ray_tpu_torch.get_runtime_context().get_node_id()
        if location != "EveryNode":
            nodes = [n for n in nodes if n["node_id"] == local_hex]
        for n in nodes or [{"node_id": local_hex}]:
            nid = n["node_id"]
            # every node's proxy tries the SAME configured port (one
            # proxy per host on a real pod); co-located nodes in
            # single-host test clusters lose the bind race and fall
            # back to an ephemeral port inside HTTPProxy
            cls = ray_tpu_torch.remote(
                num_cpus=0, max_concurrency=16,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=nid, soft=True))(HTTPProxy)
            actor = cls.remote(controller, host, port)
            _proxy_actors[nid] = actor
            if nid == local_hex or _proxy_actor is None:
                _proxy_actor = actor
    if grpc_options is not None and _grpc_proxy_actor is None:
        from ray_tpu_torch.serve._private.grpc_proxy import GrpcProxy
        gcls = ray_tpu_torch.remote(num_cpus=0.25,
                              max_concurrency=16)(GrpcProxy)
        _grpc_proxy_actor = gcls.remote(
            controller, grpc_options.get("host", "127.0.0.1"),
            grpc_options.get("port", 9000),
            grpc_options.get("grpc_servicer_functions", ()))


def grpc_proxy_address() -> Optional[str]:
    if _grpc_proxy_actor is None:
        return None
    return ray_tpu_torch.get(_grpc_proxy_actor.address.remote())


def proxy_address() -> Optional[str]:
    if _proxy_actor is None:
        return None
    return ray_tpu_torch.get(_proxy_actor.address.remote())


def proxy_addresses() -> Dict[str, str]:
    """All per-node proxy addresses, keyed by node id hex."""
    return {nid: ray_tpu_torch.get(a.address.remote())
            for nid, a in _proxy_actors.items()}


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    controller = _controller_or_none()
    if controller is None:
        raise RuntimeError("Serve is not running")
    return DeploymentHandle(deployment_name, controller, app_name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _controller_or_none()
    if controller is None:
        raise RuntimeError("Serve is not running")
    ingress = ray_tpu_torch.get(controller.get_app_ingress.remote(name))
    if ingress is None:
        raise RuntimeError(f"No application named {name!r}")
    return DeploymentHandle(ingress, controller, name)


def status() -> Dict[str, Any]:
    controller = _controller_or_none()
    if controller is None:
        return {"deployments": []}
    return {"deployments": ray_tpu_torch.get(
        controller.list_deployments.remote())}


def delete(name: str) -> None:
    controller = _controller_or_none()
    if controller is not None:
        ray_tpu_torch.get(controller.delete_deployment.remote(name))


def shutdown() -> None:
    global _proxy_actor, _grpc_proxy_actor
    controller = _controller_or_none()
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(controller)
        except Exception:
            pass
    for actor in set(_proxy_actors.values()) | (
            {_proxy_actor} if _proxy_actor is not None else set()):
        try:
            ray_tpu_torch.get(actor.stop.remote(), timeout=10)
            ray_tpu_torch.kill(actor)
        except Exception:
            pass
    _proxy_actors.clear()
    _proxy_actor = None
    if _grpc_proxy_actor is not None:
        try:
            ray_tpu_torch.get(_grpc_proxy_actor.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_grpc_proxy_actor)
        except Exception:
            pass
        _grpc_proxy_actor = None
