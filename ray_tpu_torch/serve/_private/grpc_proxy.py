"""gRPC ingress proxy.

Reference: ``python/ray/serve/_private/proxy.py`` runs an HTTP *and* a
gRPC proxy per node; the gRPC side (``grpc_util.py``, serve's
``RayServeAPIService``) routes by application name carried in the
request. Here a generic-handler service avoids protoc codegen: one
``Predict`` method takes a JSON payload, routes through the same
DeploymentHandle machinery as HTTP, and returns the JSON result;
``Healthz``/``ListApplications`` mirror the reference's service API.

The wire format is JSON (like the HTTP ingress), NOT pickle: ingress
ports sit on a network trust boundary, and unpickling peer-controlled
bytes would be remote code execution.

Wire contract (UTF-8 JSON bytes):
  /ray_tpu_torch.serve.ServeAPIService/Predict
      request  = {"app": str, "args": [...], "kwargs": {...}}
      response = {"result": ...} or {"error": str}
  /ray_tpu_torch.serve.ServeAPIService/Healthz          -> "OK"
  /ray_tpu_torch.serve.ServeAPIService/ListApplications -> [names]
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Any, Optional

SERVICE = "ray_tpu_torch.serve.ServeAPIService"


class _ForwardingServicer:
    """Servicer for a USER-DEFINED gRPC service (reference:
    ``src/ray/protobuf/serve.proto:150`` UserDefinedService +
    ``gRPCOptions.grpc_servicer_functions``): the user passes their
    protoc-generated ``add_XServicer_to_server`` functions, which look
    up RPC method names on this object via ``getattr`` — every method
    resolves to a forwarder that routes the TYPED request message to
    the target application's ingress deployment (the deployment method
    named like the RPC if it exists, else ``__call__``) and returns the
    deployment's TYPED response message, which the generated handler
    serializes with the user's proto."""

    def __init__(self, proxy: "GrpcProxy"):
        self._proxy = proxy

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        proxy = self._proxy

        def forward(request, context):
            md = dict(context.invocation_metadata() or ())
            app = md.get("application", "default")
            try:
                return proxy._dispatch(app, (request,), {},
                                       method=method_name)
            except BaseException as e:  # noqa: BLE001
                import grpc
                context.abort(grpc.StatusCode.INTERNAL, repr(e))

        return forward


class GrpcProxy:
    """Actor hosting the gRPC server (one per cluster, like the HTTP
    proxy actor). ``grpc_servicer_functions`` registers user-defined
    proto services alongside the built-in JSON ServeAPIService."""

    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 9000, grpc_servicer_functions=()):
        import grpc

        import ray_tpu_torch
        self._controller = controller
        self._ray = ray_tpu_torch
        # app -> (ingress deployment name, handle); re-validated against
        # the controller on every call so redeploys take effect
        self._handles: dict = {}

        proxy = self

        def predict(request: bytes, context) -> bytes:
            try:
                req = json.loads(request.decode() or "{}")
                out = proxy._dispatch(req.get("app", "default"),
                                      tuple(req.get("args", ())),
                                      req.get("kwargs", {}))
                return json.dumps({"result": out}, default=str).encode()
            except BaseException as e:  # noqa: BLE001
                return json.dumps({"error": repr(e)}).encode()

        def healthz(request: bytes, context) -> bytes:
            return json.dumps("OK").encode()

        def list_apps(request: bytes, context) -> bytes:
            apps = self._ray.get(
                self._controller.list_applications.remote())
            return json.dumps(list(apps)).encode()

        ident = lambda b: b  # noqa: E731 — bytes in, bytes out
        handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict, request_deserializer=ident,
                response_serializer=ident),
            "Healthz": grpc.unary_unary_rpc_method_handler(
                healthz, request_deserializer=ident,
                response_serializer=ident),
            "ListApplications": grpc.unary_unary_rpc_method_handler(
                list_apps, request_deserializer=ident,
                response_serializer=ident),
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        # user-defined typed services: protoc-generated (or compatible)
        # add_*Servicer_to_server callables, exactly the reference's
        # gRPCOptions.grpc_servicer_functions contract
        servicer = _ForwardingServicer(self)
        for fn in grpc_servicer_functions or ():
            if isinstance(fn, str):
                import importlib
                mod, _, attr = fn.rpartition(".")
                fn = getattr(importlib.import_module(mod), attr)
            fn(servicer, self._server)
        bound = self._server.add_insecure_port(f"{host}:{port}")
        if bound == 0 and port != 0:
            raise OSError(
                f"gRPC proxy could not bind {host}:{port} "
                f"(port already in use?)")
        self._port = bound
        self._host = host
        self._server.start()

    def _dispatch(self, app: str, args: tuple, kwargs: dict,
                  method: Optional[str] = None) -> Any:
        ingress = self._ray.get(
            self._controller.get_app_ingress.remote(app))
        if ingress is None:
            raise RuntimeError(f"No application named {app!r}")
        cached = self._handles.get(app)
        if cached is None or cached[0] != ingress:
            from ray_tpu_torch.serve.handle import DeploymentHandle
            # per-app cache: (ingress, handle, method-routing verdicts);
            # invalidated wholesale on redeploy (ingress change)
            cached = (ingress,
                      DeploymentHandle(ingress, self._controller, app),
                      {})
            self._handles[app] = cached
        handle = cached[1]
        if method:
            has = cached[2].get(method)
            if has is None:
                has = cached[2][method] = self._ray.get(
                    self._controller.app_has_method.remote(app, method))
            if has:
                # typed user-service RPC: route to the deployment
                # method named like the RPC (reference: serve's gRPC
                # ingress maps RPC names onto deployment methods)
                return getattr(handle, method).remote(
                    *args, **kwargs).result(timeout_s=60)
        return handle.remote(*args, **kwargs).result(timeout_s=60)

    def address(self) -> str:
        return f"{self._host}:{self._port}"

    def stop(self) -> None:
        self._server.stop(grace=None)


def _unary(address: str, method: str, payload: bytes,
           timeout_s: float) -> bytes:
    import grpc
    channel = grpc.insecure_channel(address)
    try:
        fn = channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        return fn(payload, timeout=timeout_s)
    finally:
        channel.close()


def grpc_call(address: str, app: str, *args, timeout_s: float = 60.0,
              **kwargs) -> Any:
    """Client helper (reference: serve's gRPC client examples)."""
    out = json.loads(_unary(
        address, "Predict",
        json.dumps({"app": app, "args": list(args),
                    "kwargs": kwargs}).encode(),
        timeout_s))
    if "error" in out:
        raise RuntimeError(f"serve gRPC call failed: {out['error']}")
    return out["result"]


def grpc_healthz(address: str, timeout_s: float = 10.0) -> str:
    return json.loads(_unary(address, "Healthz", b"", timeout_s))


def grpc_list_applications(address: str,
                           timeout_s: float = 10.0) -> list:
    return json.loads(_unary(address, "ListApplications", b"",
                             timeout_s))
