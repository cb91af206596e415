"""HTTP request/response model + the ASGI ingress adapter.

Reference: ``python/ray/serve/api.py`` (``@serve.ingress`` wraps a
FastAPI/ASGI app into a deployment class) and
``_private/http_util.py`` (``ASGIReceiveProxy`` / response streaming).
The proxy ships a picklable request snapshot to the
replica; the replica runs the ASGI app and streams its send() events
back through the ordinary deployment streaming channel (a core
streaming generator task — ``Replica.handle_request_stream`` with
``num_returns="streaming"``), so FastAPI ``StreamingResponse`` bodies
flow to the HTTP client chunk by chunk without the proxy ever
importing the user's app.
"""

from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl

__all__ = ["Request", "Response", "ingress"]


class Request:
    """Picklable HTTP request snapshot handed to deployments.

    Plain deployments may accept it (reference: Starlette Request);
    the ASGI adapter reconstitutes a full scope from it."""

    __slots__ = ("method", "path", "query_string", "headers", "body")

    def __init__(self, method: str, path: str, query_string: str = "",
                 headers: Optional[List[Tuple[str, str]]] = None,
                 body: bytes = b""):
        self.method = method
        self.path = path
        self.query_string = query_string
        self.headers = headers or []
        self.body = body

    def header(self, name: str, default: str = "") -> str:
        name = name.lower()
        for k, v in self.headers:
            if k.lower() == name:
                return v
        return default

    @property
    def query_params(self) -> Dict[str, str]:
        return dict(parse_qsl(self.query_string))

    def json(self) -> Any:
        return _json.loads(self.body) if self.body else None

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")


class Response:
    """Returned by plain deployments to control status/headers/body."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, body: Any = b"", status: int = 200,
                 headers: Optional[List[Tuple[str, str]]] = None,
                 content_type: Optional[str] = None):
        self.status = status
        self.headers = list(headers or [])
        if isinstance(body, str):
            body = body.encode()
            content_type = content_type or "text/plain; charset=utf-8"
        elif not isinstance(body, (bytes, bytearray)):
            body = _json.dumps(body).encode()
            content_type = content_type or "application/json"
        self.body = bytes(body)
        if content_type and not any(
                k.lower() == "content-type" for k, _ in self.headers):
            self.headers.append(("Content-Type", content_type))


def _scope_from_request(req: Request) -> dict:
    return {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": req.method,
        "scheme": "http",
        "path": req.path,
        "raw_path": req.path.encode(),
        "root_path": "",
        "query_string": req.query_string.encode(),
        "headers": [(k.lower().encode(), v.encode())
                    for k, v in req.headers],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
    }


def ingress(app):
    """Class decorator mounting an ASGI app as the deployment's HTTP
    surface (reference: ``serve.ingress``, python/ray/serve/api.py).

    Usage::

        fastapi_app = FastAPI()

        @serve.deployment
        @serve.ingress(fastapi_app)
        class MyApp:
            ...

    The decorated class gains ``__serve_asgi_stream__`` — an async
    generator the proxy drives with ``options(stream=True)``; each
    yielded item is one ASGI send() event, so streaming responses reach
    the client incrementally."""

    def decorator(cls):
        import asyncio
        import inspect

        class ASGIIngress(cls):
            __serve_asgi__ = True

            async def __serve_asgi_stream__(self, request: Request):
                scope = _scope_from_request(request)
                queue: "asyncio.Queue" = asyncio.Queue()
                body = request.body
                sent = False

                async def receive():
                    nonlocal sent
                    if not sent:
                        sent = True
                        return {"type": "http.request", "body": body,
                                "more_body": False}
                    # app awaits disconnect after the response: park
                    # forever — the task is cancelled when the stream
                    # generator is closed
                    await asyncio.Event().wait()

                async def send(event):
                    await queue.put(event)

                target = app
                # support bound sub-app factories: attribute name of an
                # ASGI app on the instance
                if isinstance(target, str):
                    target = getattr(self, target)
                task = asyncio.ensure_future(target(scope, receive, send))
                try:
                    while True:
                        get = asyncio.ensure_future(queue.get())
                        done, _ = await asyncio.wait(
                            {get, task},
                            return_when=asyncio.FIRST_COMPLETED)
                        if get in done:
                            event = get.result()
                            yield event
                            if event.get("type") == "http.response.body" \
                                    and not event.get("more_body"):
                                break
                        else:
                            get.cancel()
                            # app finished (or crashed) without a final
                            # body event
                            exc = task.exception()
                            if exc is not None:
                                raise exc
                            while not queue.empty():
                                yield queue.get_nowait()
                            break
                finally:
                    if not task.done():
                        task.cancel()

        ASGIIngress.__name__ = getattr(cls, "__name__", "ASGIIngress")
        ASGIIngress.__qualname__ = ASGIIngress.__name__
        ASGIIngress.__module__ = getattr(cls, "__module__", __name__)
        return ASGIIngress

    return decorator
