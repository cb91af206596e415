"""Dashboard head: JSON-over-HTTP API in the head process.

Reference: ``python/ray/dashboard/head.py:81`` (aiohttp app aggregating
module routes) + ``modules/job/job_head.py`` (the /api/jobs/ REST
surface the Job SDK talks to). Route shapes match the reference's job
API so a reference SDK user finds the same contract; cluster state comes
straight from the controller's state tables instead of per-node agents.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

from ray_tpu_torch.dashboard.job_manager import JobManager

logger = logging.getLogger(__name__)


class DashboardHead:
    def __init__(self, session_dir: str, controller, port: int = 0):
        self.session_dir = session_dir
        self.controller = controller
        self.job_manager = JobManager(session_dir)
        handler = _make_handler(self)
        self.server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.address = f"http://127.0.0.1:{self.server.server_address[1]}"
        try:
            # discoverable by external clients / the CLI (reference analog:
            # the dashboard URL recorded in the GCS + ray.init() banner);
            # written BEFORE serving so a failure here can't leak a live
            # server with no handle to stop it
            with open(os.path.join(session_dir, "dashboard.json"), "w") as f:
                json.dump({"address": self.address}, f)
        except Exception:
            self.server.server_close()
            raise
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="dashboard-http",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.job_manager.shutdown()
        try:
            self.server.shutdown()
            self.server.server_close()
        except Exception:
            pass

    # ----------------------------------------------------------- serve
    def serve_controller(self):
        """Handle to the named serve controller actor, or None when
        serve was never started. The head process is the driver, so
        its global worker resolves named actors directly."""
        try:
            import ray_tpu_torch
            from ray_tpu_torch.serve._private.controller import \
                CONTROLLER_NAME
            return ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:
            return None

    # ----------------------------------------------------- cluster state
    def state(self, what: str, limit: int = 1000):
        """Live state rows for the UI (same snapshot the wire state API
        serves; reference: dashboard state_aggregator over GCS)."""
        return self.controller.call_on_loop(
            lambda: self.controller.state_rows(what, limit))

    def cluster_status(self) -> dict:
        # controller state is single-thread-owned: snapshot on its loop
        return self.controller.call_on_loop(self._cluster_status_locked)

    def _cluster_status_locked(self) -> dict:
        c = self.controller
        nodes = []
        for node in c.nodes.values():
            nodes.append({
                "node_id": node.node_id.hex(),
                "alive": node.alive,
                "resources_total": dict(node.resources.total),
                "resources_available": dict(node.resources.available),
                "num_workers": len(node.all_workers),
            })
        states: dict = {}
        for row in c.task_table.values():
            states[row.get("state", "?")] = \
                states.get(row.get("state", "?"), 0) + 1
        return {
            "nodes": nodes,
            "num_actors": len(c.actors),
            "num_objects": len(c.objects),
            "task_states": states,
            "num_pending_tasks": len(c.tasks),
        }


def _make_handler(head: DashboardHead):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            logger.debug("dashboard: " + fmt, *args)

        # -- helpers --
        def _json(self, obj: Any, code: int = 200) -> None:
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _text(self, text: str, code: int = 200) -> None:
            blob = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            if not n:
                return {}
            return json.loads(self.rfile.read(n) or b"{}")

        def _job_id_from(self, path: str) -> Optional[str]:
            parts = [p for p in path.split("/") if p]
            # /api/jobs/<id>[/logs|/stop]
            return parts[2] if len(parts) >= 3 else None

        def _html(self, text: str) -> None:
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- routes --
        def do_GET(self):
            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/")
            try:
                if path in ("", "/index.html"):
                    from ray_tpu_torch.dashboard.static_ui import INDEX_HTML
                    self._html(INDEX_HTML)
                elif path.startswith("/api/state/"):
                    what = path.split("/")[-1]
                    if what not in ("nodes", "actors", "tasks",
                                    "objects", "placement_groups",
                                    "jobs", "node_processes"):
                        self._json({"error": f"unknown state {what!r}"},
                                   404)
                        return
                    from urllib.parse import parse_qs
                    q = parse_qs(parsed.query)
                    try:
                        limit = int(q.get("limit", ["1000"])[0])
                    except ValueError:
                        self._json({"error": "limit must be an int"},
                                   400)
                        return
                    self._json({"rows": head.state(what, limit)})
                elif path == "/metrics":
                    # the single cluster Prometheus scrape target:
                    # every process's samples, labelled by origin
                    # (node/pid/role). MetricsPlane is internally
                    # locked, so no loop marshal is needed.
                    self._text(
                        head.controller.metrics_plane.prometheus_text())
                elif path == "/api/v0/metrics":
                    self._json(
                        {"metrics":
                         head.controller.metrics_plane.catalog()})
                elif path == "/api/v0/metrics/query":
                    # ?name=<metric>&window=<s>&agg=<rate|sum|p99|...>
                    from urllib.parse import parse_qs
                    q = parse_qs(parsed.query)
                    name = (q.get("name") or [""])[0]
                    if not name:
                        self._json({"error": "name query param "
                                    "required"}, 400)
                        return
                    try:
                        window = float((q.get("window") or ["60"])[0])
                    except ValueError:
                        self._json({"error": "window must be a "
                                    "number"}, 400)
                        return
                    agg = (q.get("agg") or [None])[0]
                    try:
                        self._json(head.controller.metrics_plane.query(
                            name, window_s=window, agg=agg))
                    except ValueError as e:
                        self._json({"error": str(e)}, 400)
                elif path == "/api/v0/metrics/fleet":
                    from urllib.parse import parse_qs
                    q = parse_qs(parsed.query)
                    try:
                        window = float((q.get("window") or ["30"])[0])
                    except ValueError:
                        self._json({"error": "window must be a "
                                    "number"}, 400)
                        return
                    self._json(
                        head.controller.metrics_plane.fleet_summary(
                            window_s=window))
                elif path == "/api/timeline":
                    self._json(head.state("timeline", 100_000))
                elif path == "/api/v0/events":
                    # merged flight-recorder stream (core/events.py);
                    # ?task=<hex> narrows to one task, ?ev=<EVENT>
                    # to one event type
                    from urllib.parse import parse_qs
                    q = parse_qs(parsed.query)
                    rows = head.state("task_events", 100_000)
                    task = (q.get("task") or [None])[0]
                    if task:
                        rows = [r for r in rows if r.get("task") == task]
                    ev = (q.get("ev") or [None])[0]
                    if ev:
                        rows = [r for r in rows if r.get("ev") == ev]
                    try:
                        limit = int(q.get("limit", ["100000"])[0])
                    except ValueError:
                        self._json({"error": "limit must be an int"},
                                   400)
                        return
                    self._json({"rows": rows[-limit:]})
                elif path == "/timeline":
                    # Perfetto/Chrome-trace JSON of the flight-recorder
                    # stream: load it at https://ui.perfetto.dev or
                    # chrome://tracing (one track per process, flow
                    # arrows along trace ids). Fleet metric series ride
                    # along as counter tracks ("ph":"C") — tokens/s,
                    # queue depth and occupancy curves next to spans.
                    from ray_tpu_torch.core.events import build_chrome_trace
                    store = head.controller.request_traces
                    self._json(build_chrome_trace(
                        head.state("task_events", 100_000),
                        counters=head.controller.metrics_plane
                        .chrome_counters(),
                        requests=[w for w in (
                            store.waterfall(r["request_id"])
                            for r in store.rows(limit=50))
                            if w is not None]))
                elif path == "/api/v0/requests":
                    # tail-sampled request-trace summaries (slow /
                    # failed / 1-in-N); RequestTraceStore is internally
                    # locked like MetricsPlane, so no loop marshal
                    from urllib.parse import parse_qs
                    q = parse_qs(parsed.query)
                    try:
                        limit = int(q.get("limit", ["50"])[0])
                    except ValueError:
                        self._json({"error": "limit must be an int"},
                                   400)
                        return
                    self._json({"rows": head.controller
                                .request_traces.rows(limit=limit)})
                elif path.startswith("/api/v0/requests/"):
                    # /api/v0/requests/<request_id> -> full waterfall
                    rid = path.rsplit("/", 1)[-1]
                    w = head.controller.request_traces.waterfall(rid)
                    if w is None:
                        self._json(
                            {"error": f"no trace for {rid!r} (fast "
                             "requests outside the tail sample ship "
                             "no spans)"}, 404)
                    else:
                        self._json(w)
                elif path == "/api/jobs":
                    self._json(head.job_manager.list_jobs())
                elif path == "/api/v0/admission/policy":
                    ctrl = head.serve_controller()
                    if ctrl is None:
                        self._json({"error": "no serve controller"},
                                   404)
                        return
                    import ray_tpu_torch
                    seq, policy = ray_tpu_torch.get(
                        ctrl.get_admission_policy.remote())
                    self._json({"seq": seq, "policy": policy})
                elif path == "/api/v0/arbiter":
                    # live slice-arbitration table (who owns which
                    # slice and why); present only when the head runs
                    # with an arbiter: config section
                    arb = getattr(head.controller, "slice_arbiter",
                                  None)
                    if arb is None:
                        self._json({"error": "no slice arbiter "
                                    "configured"}, 404)
                    else:
                        self._json(arb.status())
                elif path == "/api/version":
                    from ray_tpu_torch import __version__
                    self._json({"version": __version__,
                                "ray_tpu_session": head.session_dir})
                elif path == "/api/cluster_status":
                    self._json(head.cluster_status())
                elif path.startswith("/api/nodes/") \
                        and path.endswith("/profile"):
                    # /api/nodes/<node_hex>/profile?worker=<hex>&
                    # duration=2 -> collapsed-stack flamegraph artifact
                    # (reference: reporter agent's on-demand profiling,
                    # profile_manager.py:79)
                    from urllib.parse import parse_qs
                    q = parse_qs(parsed.query)
                    worker_hex = (q.get("worker") or [""])[0]
                    if not worker_hex:
                        self._json(
                            {"error": "worker query param required "
                             "(hex identity from "
                             "/api/state/node_processes)"}, 400)
                        return
                    try:
                        duration = float(
                            (q.get("duration") or ["2"])[0])
                    except ValueError:
                        self._json({"error": "bad duration"}, 400)
                        return
                    result = head.controller.profile_worker(
                        bytes.fromhex(worker_hex),
                        duration_s=min(duration, 30.0))
                    if result is None:
                        self._json({"error": "profile timed out "
                                    "(worker gone?)"}, 504)
                    elif result.get("error"):
                        self._json({"error": result["error"]}, 500)
                    else:
                        self._text(result.get("collapsed") or "")
                elif path.startswith("/api/jobs/") and path.endswith("/logs"):
                    jid = self._job_id_from(path)
                    if head.job_manager.get_job_info(jid) is None:
                        self._json({"error": f"job {jid!r} not found"}, 404)
                    else:
                        self._json(
                            {"logs": head.job_manager.get_job_logs(jid)})
                elif path.startswith("/api/jobs/"):
                    jid = self._job_id_from(path)
                    info = head.job_manager.get_job_info(jid)
                    if info is None:
                        self._json({"error": f"job {jid!r} not found"}, 404)
                    else:
                        self._json(info)
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # noqa: BLE001
                logger.exception("dashboard GET %s", path)
                self._json({"error": str(e)}, 500)

        def do_POST(self):
            path = urlparse(self.path).path.rstrip("/")
            try:
                if path == "/api/jobs":
                    body = self._body()
                    if not body.get("entrypoint"):
                        self._json({"error": "entrypoint is required"}, 400)
                        return
                    jid = head.job_manager.submit_job(
                        entrypoint=body["entrypoint"],
                        submission_id=body.get("submission_id"),
                        metadata=body.get("metadata"),
                        runtime_env=body.get("runtime_env"),
                        priority=body.get("priority") or "normal",
                        elastic=bool(body.get("elastic")))
                    self._json({"submission_id": jid})
                elif path.startswith("/api/jobs/") and path.endswith("/stop"):
                    jid = self._job_id_from(path)
                    try:
                        stopped = head.job_manager.stop_job(jid)
                        self._json({"stopped": stopped})
                    except KeyError:
                        self._json({"error": f"job {jid!r} not found"}, 404)
                elif path == "/api/v0/admission/policy":
                    # fleet-wide admission budget refresh: validate
                    # here (bad knobs -> 400 via the ValueError
                    # handler below, nothing stored), then push to
                    # the serve controller's config plane; routers
                    # with admission enabled pick it up on their next
                    # rate-limited poll
                    from ray_tpu_torch.serve.admission import AdmissionPolicy
                    body = self._body()
                    policy = AdmissionPolicy.from_dict(body)
                    ctrl = head.serve_controller()
                    if ctrl is None:
                        self._json({"error": "no serve controller "
                                    "(serve not started)"}, 404)
                        return
                    import ray_tpu_torch
                    seq = ray_tpu_torch.get(
                        ctrl.set_admission_policy.remote(
                            policy.to_dict()))
                    self._json({"seq": seq,
                                "policy": policy.to_dict()})
                else:
                    self._json({"error": "not found"}, 404)
            except ValueError as e:
                self._json({"error": str(e)}, 400)
            except Exception as e:  # noqa: BLE001
                logger.exception("dashboard POST %s", path)
                self._json({"error": str(e)}, 500)

    return Handler
