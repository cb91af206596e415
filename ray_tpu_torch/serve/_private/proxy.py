"""HTTP ingress proxy: asyncio server with streaming + ASGI dispatch.

Reference: ``python/ray/serve/_private/proxy.py`` (per-node uvicorn/ASGI
proxy + ``ProxyRouter`` longest-prefix routing, streaming responses
wired to handle generators). This build keeps the reference's dispatch
model without requiring uvicorn: a stdlib asyncio HTTP/1.1 server whose
blocking object-store pulls run on a thread pool, with three dispatch
modes per route (flags from ``ServeController.get_routes_info``):

- **unary** — legacy JSON-over-HTTP: parse body as JSON, call the
  handle, JSON the result (back-compat with round-3 clients).
- **streaming** — deployments whose ``__call__`` is a (async) generator
  stream chunks to the client as they are produced, via
  ``DeploymentResponseGenerator`` over a core ``ObjectRefGenerator``
  (items pushed as produced, consumer-paced by the core backpressure
  window, delivery covered by the reliable-transport guarantees).
- **asgi** — ``@serve.ingress`` deployments: the whole request ships to
  the replica, the ASGI app's send() events stream back and are written
  to the socket incrementally (FastAPI StreamingResponse works
  end-to-end).

Responses close the connection (``Connection: close``) — body framing
by EOF keeps the writer trivial and curl/browser compatible.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.serve.http import Request, Response
from ray_tpu_torch.serve.request_trace import new_request_id

MAX_BODY = 256 << 20          # reject absurd request bodies
ROUTE_CACHE_TTL_S = 1.0


class HTTPProxy:
    def __init__(self, controller, host: str = "127.0.0.1",
                 port: int = 8000, fallback_ephemeral: bool = True):
        #: per-node proxies all try the SAME configured port (one per
        #: host on a real pod); co-located nodes (single-host test
        #: clusters) lose the race and fall back to an ephemeral port
        self._fallback_ephemeral = fallback_ephemeral
        self._controller = controller
        self._handles: Dict[str, Any] = {}
        self._stream_handles: Dict[str, Any] = {}
        # (prefill, decode) -> DisaggRouter, for disagg-flagged routes
        self._disagg_routers: Dict[Tuple[str, str], Any] = {}
        self._routes: Dict[str, dict] = {}
        self._routes_at = 0.0
        self._routes_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="serve-http")
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._server = None
        self.port = None
        self.host = host
        self._thread = threading.Thread(
            target=self._run_loop, args=(host, port),
            name="serve_http", daemon=True)
        self._thread.start()
        self._started.wait(timeout=10)
        if self.port is None:
            raise RuntimeError("HTTP proxy failed to bind "
                               f"{host}:{port}")

    # ------------------------------------------------------------ server
    def _run_loop(self, host: str, port: int) -> None:
        asyncio.set_event_loop(self._loop)

        async def boot():
            try:
                self._server = await asyncio.start_server(
                    self._serve_conn, host, port)
            except OSError:
                if not (self._fallback_ephemeral and port):
                    raise
                self._server = await asyncio.start_server(
                    self._serve_conn, host, 0)
            self.port = self._server.sockets[0].getsockname()[1]
            self._started.set()

        try:
            self._loop.run_until_complete(boot())
        except OSError:
            self._started.set()
            return
        self._loop.run_forever()

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            await self._dispatch(req, writer)
        except _HTTPError as e:
            try:
                await self._write_simple(writer, e.status,
                                         {"error": e.message})
            except Exception:
                pass
        except Exception as e:  # noqa: BLE001
            try:
                await self._write_simple(
                    writer, 500, {"error": str(e)})
            except Exception:
                pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        method, target, _ = lines[0].split(" ", 2)
        headers = []
        for ln in lines[1:]:
            if not ln:
                continue
            k, _, v = ln.partition(":")
            headers.append((k.strip(), v.strip()))
        path, _, query = target.partition("?")
        length = 0
        chunked = False
        for k, v in headers:
            lk = k.lower()
            if lk == "content-length":
                length = int(v)
            elif lk == "transfer-encoding" and "chunked" in v.lower():
                chunked = True
        if chunked:
            body = await self._read_chunked(reader)
        elif length:
            if length > MAX_BODY:
                raise _HTTPError(413, "request body too large")
            body = await reader.readexactly(length)
        else:
            body = b""
        return Request(method, path, query, headers, body)

    @staticmethod
    async def _read_chunked(reader) -> bytes:
        out = bytearray()
        while True:
            size_line = await reader.readline()
            size = int(size_line.strip().split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                return bytes(out)
            if len(out) + size > MAX_BODY:
                raise ValueError("chunked body too large")
            out += await reader.readexactly(size)
            await reader.readline()  # trailing CRLF

    # ------------------------------------------------------------ routes
    def _refresh_routes(self) -> None:
        # blocking: call from the thread pool, never the event loop
        routes = ray_tpu_torch.get(
            self._controller.get_routes_info.remote())
        with self._routes_lock:
            self._routes = routes
            self._routes_at = time.monotonic()

    def _match(self, path: str) -> Optional[dict]:
        # longest-prefix match (reference ProxyRouter semantics)
        with self._routes_lock:
            routes = self._routes
        for prefix in sorted(routes, key=len, reverse=True):
            if path == prefix or path.startswith(
                    prefix.rstrip("/") + "/") or prefix == "/":
                return routes[prefix]
        return None

    async def _route_for(self, path: str, loop) -> Optional[dict]:
        with self._routes_lock:
            stale = time.monotonic() - self._routes_at \
                > ROUTE_CACHE_TTL_S
        if stale:
            await loop.run_in_executor(self._pool, self._refresh_routes)
        found = self._match(path)
        if found is None and not stale:
            # never 404 off a cached table alone: a route deployed
            # moments ago must be visible immediately
            await loop.run_in_executor(self._pool, self._refresh_routes)
            found = self._match(path)
        return found

    def _handle_for(self, name: str, stream: bool, req=None,
                    request_id: Optional[str] = None):
        from ray_tpu_torch.serve.handle import DeploymentHandle
        table = self._stream_handles if stream else self._handles
        h = table.get(name)
        if h is None:
            h = DeploymentHandle(name, self._controller)
            if stream:
                h = h.options(stream=True)
            table[name] = h
        # session affinity for multi-turn clients: every request
        # carrying the same x-session-id lands on the same replica, so
        # the conversation's shared prefix stays warm in that replica's
        # radix KV cache (options() shares the cached handle's router —
        # load/affinity state spans all sessions)
        if req is not None:
            # absent headers read back as "" — keep them None so the
            # per-request options() copy (request_id is always set now)
            # doesn't turn "no x-priority header" into a 400
            sid = req.header("x-session-id") or None
            tenant = req.header("x-tenant") or None
            priority = req.header("x-priority") or None
            if sid or tenant or priority or request_id:
                try:
                    h = h.options(stream=stream, session_id=sid,
                                  tenant=tenant, priority=priority,
                                  request_id=request_id)
                except ValueError:
                    raise _HTTPError(
                        400, f"unknown x-priority {priority!r}")
        return h

    @staticmethod
    def _request_id_for(req: Request) -> str:
        """Trace identity for this HTTP request: honour the client's
        ``x-request-id`` (so their logs join our waterfalls), else mint
        one. Echoed back in the ``X-Request-Id`` response header and in
        429/500 error bodies either way."""
        return req.header("x-request-id") or new_request_id()

    # ---------------------------------------------------------- dispatch
    async def _dispatch(self, req: Request,
                        writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        route = await self._route_for(req.path, loop)
        if route is None:
            await self._write_simple(writer, 404, {"error": "no route"})
            return
        if route.get("disagg"):
            await self._dispatch_disagg(route, req, writer, loop)
        elif route["asgi"]:
            await self._dispatch_asgi(route, req, writer, loop)
        elif route["streaming"]:
            await self._dispatch_stream(route, req, writer, loop)
        else:
            await self._dispatch_unary(route, req, writer, loop)

    @staticmethod
    def _payload(req: Request) -> Any:
        return json.loads(req.body) if req.body else None

    async def _dispatch_unary(self, req_route, req, writer, loop):
        rid = self._request_id_for(req)
        handle = self._handle_for(req_route["name"], stream=False,
                                  req=req, request_id=rid)

        def call():
            payload = self._payload(req)
            resp = handle.remote(payload) if payload is not None \
                else handle.remote()
            return resp.result(timeout_s=60)

        try:
            result = await loop.run_in_executor(self._pool, call)
        except Exception as e:  # noqa: BLE001
            await self._write_error(writer, e, request_id=rid)
            return
        if isinstance(result, Response):
            await self._write_head(writer, result.status, result.headers
                                   + [("X-Request-Id", rid),
                                      ("Content-Length",
                                       str(len(result.body)))])
            writer.write(result.body)
            await writer.drain()
            return
        await self._write_simple(writer, 200, result,
                                 extra_headers=[("X-Request-Id", rid)])

    async def _dispatch_stream(self, req_route, req, writer, loop):
        rid = self._request_id_for(req)
        handle = self._handle_for(req_route["name"], stream=True,
                                  req=req, request_id=rid)

        def start():
            payload = self._payload(req)
            return handle.remote(payload) if payload is not None \
                else handle.remote()

        try:
            gen = await loop.run_in_executor(self._pool, start)
            # core streaming: tokens arrive as the replica produces
            # them (STREAM_ITEM push), so each next() returns the next
            # token without a polling round-trip
            it = iter(gen)
            first = await loop.run_in_executor(
                self._pool, next, it, _END)
        except Exception as e:  # noqa: BLE001
            # admission sheds before headers go out, so a 429 is still
            # expressible here (unlike mid-stream failures below)
            await self._write_error(writer, e, request_id=rid)
            return
        await self._write_head(
            writer, 200,
            [("Content-Type", "text/plain; charset=utf-8"),
             ("X-Request-Id", rid),
             ("X-Accel-Buffering", "no")])
        try:
            chunk = first
            while chunk is not _END:
                writer.write(_as_bytes(chunk))
                await writer.drain()
                chunk = await loop.run_in_executor(
                    self._pool, next, it, _END)
        except BaseException:  # noqa: BLE001
            # headers are out: closing mid-body IS the error signal —
            # a second "500" head spliced into the body would corrupt
            # the stream. Cancel so the replica's live stream (and its
            # ongoing-count used for load balancing) is not leaked.
            gen.cancel()

    async def _dispatch_disagg(self, req_route, req, writer, loop):
        """Disaggregated route: drive the (prefill, decode) pair
        through a cached :class:`~ray_tpu_torch.serve.disagg.DisaggRouter`
        instead of a single-deployment handle. Body: a prompt-id list,
        or ``{"prompt": [...], "max_new_tokens": n}``; tokens stream
        back exactly like a colocated streaming route."""
        rid = self._request_id_for(req)
        pair = req_route["disagg"]
        key = (pair["prefill"], pair["decode"])
        router = self._disagg_routers.get(key)
        if router is None:
            from ray_tpu_torch.serve.disagg import DisaggRouter
            router = DisaggRouter(pair["prefill"], pair["decode"],
                                  self._controller)
            self._disagg_routers[key] = router
        sid = req.header("x-session-id") or None
        payload = self._payload(req)
        if isinstance(payload, dict):
            prompt = payload.get("prompt") or []
            mnt = payload.get("max_new_tokens")
        else:
            prompt, mnt = payload or [], None

        def start():
            it = router.options(
                stream=True, session_id=sid,
                request_id=rid).generate.remote(prompt, mnt)
            return it, iter(it)

        try:
            gen, it = await loop.run_in_executor(self._pool, start)
            first = await loop.run_in_executor(
                self._pool, next, it, _END)
        except Exception as e:  # noqa: BLE001
            await self._write_error(writer, e, request_id=rid)
            return
        await self._write_head(
            writer, 200,
            [("Content-Type", "text/plain; charset=utf-8"),
             ("X-Request-Id", rid),
             ("X-Accel-Buffering", "no")])
        try:
            chunk = first
            while chunk is not _END:
                writer.write(_as_bytes(chunk))
                await writer.drain()
                chunk = await loop.run_in_executor(
                    self._pool, next, it, _END)
        except BaseException:  # noqa: BLE001
            # headers are out: closing mid-body is the error signal
            gen.close()

    async def _dispatch_asgi(self, req_route, req, writer, loop):
        handle = self._handle_for(req_route["name"], stream=True)

        def start():
            # internal dunder method: bypass the public __getattr__
            # (which refuses underscore names)
            return handle._route("__serve_asgi_stream__", (req,), {})

        try:
            gen = await loop.run_in_executor(self._pool, start)
            it = iter(gen)
            first = await loop.run_in_executor(
                self._pool, next, it, _END)
        except Exception as e:  # noqa: BLE001
            await self._write_simple(writer, 500, {"error": str(e)})
            return
        started = False
        try:
            event = first
            while event is not _END:
                if event["type"] == "http.response.start":
                    headers = [
                        (k.decode("latin-1"), v.decode("latin-1"))
                        for k, v in event.get("headers", [])]
                    headers = [(k, v) for k, v in headers
                               if k.lower() not in (
                                   "connection", "transfer-encoding")]
                    await self._write_head(
                        writer, int(event["status"]), headers)
                    started = True
                elif event["type"] == "http.response.body":
                    if not started:
                        await self._write_head(writer, 200, [])
                        started = True
                    body = event.get("body", b"")
                    if body:
                        writer.write(body)
                        await writer.drain()
                event = await loop.run_in_executor(
                    self._pool, next, it, _END)
            if not started:
                await self._write_simple(writer, 500,
                                         {"error": "empty ASGI reply"})
        except BaseException:  # noqa: BLE001
            gen.cancel()
            if not started:
                await self._write_simple(
                    writer, 500, {"error": "stream failed"})

    # ------------------------------------------------------------ output
    async def _write_error(self, writer, e: BaseException,
                           request_id: Optional[str] = None) -> None:
        """Typed error mapping: an admission shed is the CLIENT's
        signal to back off (429 + tenant/priority/reason so it can
        retry with a higher class), not a server fault. Both bodies
        carry ``request_id`` — the same id the SHED/FAILED waterfall is
        filed under, so ``ray-tpu trace <id>`` explains the error."""
        from ray_tpu_torch.exceptions import AdmissionRejectedError
        if isinstance(e, AdmissionRejectedError):
            rid = e.request_id or request_id or ""
            await self._write_simple(
                writer, 429,
                {"error": str(e), "tenant": e.tenant,
                 "priority": e.priority, "reason": e.reason,
                 "request_id": rid},
                extra_headers=[("X-Request-Id", rid)] if rid else None)
            return
        await self._write_simple(
            writer, 500,
            {"error": str(e), "request_id": request_id or ""},
            extra_headers=([("X-Request-Id", request_id)]
                           if request_id else None))

    @staticmethod
    async def _write_head(writer, status: int,
                          headers) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  500: "Internal Server Error"}.get(status, "")
        out = [f"HTTP/1.1 {status} {reason}".encode()]
        seen_ct = False
        for k, v in headers:
            seen_ct = seen_ct or k.lower() == "content-type"
            out.append(f"{k}: {v}".encode("latin-1"))
        if not seen_ct:
            out.append(b"Content-Type: application/octet-stream")
        out.append(b"Connection: close")
        writer.write(b"\r\n".join(out) + b"\r\n\r\n")
        await writer.drain()

    async def _write_simple(self, writer, status: int, payload: Any,
                            extra_headers=None) -> None:
        body = json.dumps(payload).encode()
        await self._write_head(
            writer, status,
            [("Content-Type", "application/json"),
             ("Content-Length", str(len(body)))]
            + list(extra_headers or []))
        writer.write(body)
        await writer.drain()

    # --------------------------------------------------------------- api
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def node_id(self) -> Optional[str]:
        return ray_tpu_torch.get_runtime_context().get_node_id()

    def stop(self) -> None:
        def shutdown():
            if self._server is not None:
                self._server.close()
            self._loop.stop()
        self._loop.call_soon_threadsafe(shutdown)
        self._pool.shutdown(wait=False)


_END = object()


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _as_bytes(chunk: Any) -> bytes:
    if isinstance(chunk, (bytes, bytearray)):
        return bytes(chunk)
    if isinstance(chunk, str):
        return chunk.encode()
    return (json.dumps(chunk) + "\n").encode()
