"""Workflow events: durable DAGs that block on external signals.

Reference: ``python/ray/workflow/event_listener.py`` (``EventListener``
ABC + ``TimerListener``) and ``http_event_provider.py`` (an HTTP
endpoint delivering events to waiting workflows; the port's copy of
``ray_tpu/workflow/events.py``). Shape: an
event is a DURABLE record under the workflow storage root — the HTTP
provider writes it there, so an event delivered while the cluster (or
the workflow) is down is simply found on resume; a ``wait_for_event``
node is an ordinary workflow task whose body polls for the record, so
its result checkpoints like any other task output and a resumed
workflow never re-waits a received event.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

__all__ = ["EventListener", "TimerListener", "HTTPListener",
           "wait_for_event", "deliver_event",
           "start_http_event_provider"]


def _events_dir() -> str:
    from ray_tpu_torch.workflow.api import _storage
    d = os.path.join(_storage(), "_events")
    os.makedirs(d, exist_ok=True)
    return d


def _event_path(event_key: str) -> str:
    import hashlib
    # readable prefix + hash of the RAW key: lossy sanitization alone
    # would collide distinct keys ('job/done' vs 'job_done') and
    # cross-deliver their events
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in event_key)[:48]
    digest = hashlib.sha1(event_key.encode()).hexdigest()[:12]
    return os.path.join(_events_dir(), f"{safe}.{digest}.json")


def deliver_event(event_key: str, payload: Any = None) -> None:
    """Durably record an event (what the HTTP provider does for POSTs).
    Delivery is idempotent: the first payload wins."""
    path = _event_path(event_key)
    if os.path.exists(path):
        return
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        json.dump({"event_key": event_key, "payload": payload,
                   "delivered_at": time.time()}, f)
    try:
        # atomic first-wins: link fails with EEXIST if a concurrent
        # delivery landed first (os.replace would let the last win)
        os.link(tmp, path)
    except FileExistsError:
        pass
    finally:
        os.unlink(tmp)


class EventListener:
    """Reference: event_listener.py:EventListener — implement
    ``poll_for_event`` (blocking) for a custom event source."""

    def poll_for_event(self, *args, **kwargs) -> Any:
        raise NotImplementedError

    def event_checkpointed(self, event: Any) -> None:
        """Hook for exactly-once sources to ack consumption
        (reference: event_listener.py). The built-in task-based
        ``wait_for_event`` intentionally does NOT call this — the task
        result is only durable once the workflow executor checkpoints
        it, which happens after the task returns; acking earlier could
        lose the event on a crash in between. Call it from a custom
        executor that knows the checkpoint landed."""


class TimerListener(EventListener):
    """Fires at an absolute unix timestamp (reference TimerListener)."""

    def poll_for_event(self, timestamp: float) -> float:
        delay = timestamp - time.time()
        if delay > 0:
            time.sleep(delay)
        return timestamp


class HTTPListener(EventListener):
    """Waits for a durable event record keyed by ``event_key`` —
    written by :func:`deliver_event` / the HTTP provider."""

    def __init__(self, poll_interval_s: float = 0.5):
        self.poll_interval_s = poll_interval_s

    def poll_for_event(self, event_key: str,
                       timeout_s: Optional[float] = None) -> Any:
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        path = _event_path(event_key)
        while True:
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)["payload"]
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no event {event_key!r} within {timeout_s}s")
            time.sleep(self.poll_interval_s)


def wait_for_event(listener_cls=HTTPListener, *args, **kwargs):
    """A workflow node that completes when the listener's event
    arrives (reference: ``workflow.wait_for_event``). The node is an
    ordinary durable task: its (checkpointed) output is the event
    payload, so resumes skip already-received events."""
    import ray_tpu_torch
    if not (isinstance(listener_cls, type)
            and issubclass(listener_cls, EventListener)):
        raise TypeError(
            f"wait_for_event takes an EventListener subclass first, "
            f"got {listener_cls!r} — e.g. "
            f"wait_for_event(HTTPListener, 'my-key')")
    from ray_tpu_torch.workflow.api import _storage
    storage_root = _storage()   # resolve DRIVER-side: the executing
    # worker must poll the same event store the provider writes to

    @ray_tpu_torch.remote
    def _wait_for_event(*a, **kw):
        from ray_tpu_torch.workflow.api import init_storage
        init_storage(storage_root)
        listener = listener_cls()
        return listener.poll_for_event(*a, **kw)

    _wait_for_event.__name__ = f"event_{listener_cls.__name__}"
    return _wait_for_event.bind(*args, **kwargs)


class _EventHTTPServer:
    """POST /event/<event_key> with a JSON body delivers that payload
    durably (reference: http_event_provider.py's endpoint, minus the
    serve dependency)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                parts = [p for p in self.path.split("/") if p]
                if len(parts) != 2 or parts[0] != "event":
                    self._reply(404, {"error": "POST /event/<key>"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n)) if n \
                        else None
                    deliver_event(parts[1], payload)
                    self._reply(200, {"delivered": parts[1]})
                except Exception as e:  # noqa: BLE001
                    self._reply(500, {"error": str(e)})

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.address = (f"http://{host}:"
                        f"{self.server.server_address[1]}")
        self._thread = threading.Thread(
            target=self.server.serve_forever,
            name="workflow-events-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def start_http_event_provider(host: str = "127.0.0.1",
                              port: int = 0) -> _EventHTTPServer:
    """Start the HTTP event endpoint; returns a handle with
    ``.address`` and ``.stop()``."""
    return _EventHTTPServer(host, port)
