"""User-defined metrics: Counter / Gauge / Histogram + Prometheus text.

Reference: ``python/ray/util/metrics.py`` (``Counter`` :137,
``Histogram`` :181, ``Gauge`` :256) flowing through the C++
OpenCensus pipeline to per-node Prometheus endpoints. Here a process-
local registry aggregates and ``export_prometheus()`` /
``serve_prometheus(port)`` expose the text format directly.

Fleet export (the cluster metrics plane, ``core/metrics_plane.py``):
``export_snapshot()`` renders the same registry as structured data —
cumulative counter values, last-value gauges, histogram bucket vectors
— and :class:`MetricsReporter` ships those snapshots periodically as
``METRIC_REPORT`` messages so the controller can aggregate every
process's metrics into one scrape target (the reference's per-node
OpenCensus→Prometheus pipeline, collapsed onto our control plane).
"""

from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]


def _label_key(tags: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((tags or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name.isidentifier():
            raise ValueError(f"Invalid metric name {name!r}")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        out.update(tags or {})
        return out

    @property
    def info(self) -> Dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys}

    def _samples(self) -> List[str]:
        raise NotImplementedError

    def snapshot(self) -> Dict:
        """Structured export for the fleet metrics plane: type, help
        text and every labelset's current value (cumulative for
        counters, last value for gauges, bucket vector + sum for
        histograms). Label keys ship as sorted ``[k, v]`` pairs so the
        payload survives JSON round-trips."""
        raise NotImplementedError

    def clear(self) -> None:
        """Drop every recorded labelset (test isolation)."""
        raise NotImplementedError

    def unregister(self) -> None:
        """Remove this metric from the process registry (it keeps
        working locally; it just stops being exported)."""
        with _registry_lock:
            try:
                _registry.remove(self)
            except ValueError:
                pass


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value <= 0:
            raise ValueError("Counter.inc requires value > 0")
        key = _label_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def bound(self, tags: Optional[Dict[str, str]] = None
              ) -> "_BoundCounter":
        """Pre-resolve the label key once; the returned handle's inc()
        skips tag merging/sorting — for per-task hot paths."""
        return _BoundCounter(self, _label_key(self._merged(tags)))

    def _samples(self) -> List[str]:
        out = [f"# TYPE {self._name} counter"]
        with self._lock:
            for key, v in self._values.items():
                out.append(f"{self._name}{_fmt_labels(key)} {v}")
        return out

    def snapshot(self) -> Dict:
        with self._lock:
            samples = [[[list(kv) for kv in key], v]
                       for key, v in self._values.items()]
        return {"name": self._name, "type": "counter",
                "desc": self._description, "samples": samples}

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_label_key(self._merged(tags))] = float(value)

    def _samples(self) -> List[str]:
        out = [f"# TYPE {self._name} gauge"]
        with self._lock:
            for key, v in self._values.items():
                out.append(f"{self._name}{_fmt_labels(key)} {v}")
        return out

    def snapshot(self) -> Dict:
        with self._lock:
            samples = [[[list(kv) for kv in key], v]
                       for key, v in self._values.items()]
        return {"name": self._name, "type": "gauge",
                "desc": self._description, "samples": samples}

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Histogram(Metric):
    def __init__(self, name, description="", boundaries=None,
                 tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._bounds = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = _label_key(self._merged(tags))
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self._bounds) + 1))
            counts[bisect.bisect_left(self._bounds, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def _samples(self) -> List[str]:
        out = [f"# TYPE {self._name} histogram"]
        with self._lock:
            for key, counts in self._counts.items():
                cum = 0
                for bound, c in zip(self._bounds, counts):
                    cum += c
                    out.append(
                        f"{self._name}_bucket"
                        f"{_fmt_labels(key, le=bound)} {cum}")
                cum += counts[-1]
                out.append(
                    f'{self._name}_bucket{_fmt_labels(key, le="+Inf")} '
                    f"{cum}")
                out.append(f"{self._name}_count{_fmt_labels(key)} {cum}")
                out.append(
                    f"{self._name}_sum{_fmt_labels(key)} "
                    f"{self._sums[key]}")
        return out

    def bound(self, tags: Optional[Dict[str, str]] = None
              ) -> "_BoundHistogram":
        """Pre-resolved-label handle (see Counter.bound)."""
        return _BoundHistogram(self, _label_key(self._merged(tags)))

    def snapshot(self) -> Dict:
        with self._lock:
            samples = [[[list(kv) for kv in key], list(counts),
                        self._sums.get(key, 0.0)]
                       for key, counts in self._counts.items()]
        return {"name": self._name, "type": "histogram",
                "desc": self._description,
                "bounds": list(self._bounds), "samples": samples}

    def clear(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sums.clear()


class _BoundCounter:
    __slots__ = ("_m", "_key")

    def __init__(self, metric: Counter, key: Tuple):
        self._m = metric
        self._key = key

    def inc(self, value: float = 1.0) -> None:
        m = self._m
        with m._lock:
            m._values[self._key] = m._values.get(self._key, 0.0) + value


class _BoundHistogram:
    __slots__ = ("_m", "_key")

    def __init__(self, metric: "Histogram", key: Tuple):
        self._m = metric
        self._key = key

    def observe(self, value: float) -> None:
        m = self._m
        with m._lock:
            counts = m._counts.setdefault(
                self._key, [0] * (len(m._bounds) + 1))
            counts[bisect.bisect_left(m._bounds, value)] += 1
            m._sums[self._key] = m._sums.get(self._key, 0.0) + value


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_labels(key: Tuple, le=None) -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if le is not None:
        parts.append(f'le="{le}"')
    if not parts:
        return ""
    return "{" + ",".join(parts) + "}"


def export_prometheus() -> str:
    """All registered metrics in Prometheus text exposition format."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        lines.extend(m._samples())
    return "\n".join(lines) + "\n"


def export_snapshot() -> List[Dict]:
    """Every registered metric's structured snapshot (the fleet-plane
    wire format: see :meth:`Metric.snapshot`)."""
    with _registry_lock:
        metrics = list(_registry)
    return [m.snapshot() for m in metrics]


# ---- registry scoping (test isolation) -------------------------------
def registry_snapshot() -> List["Metric"]:
    """The current registry membership (a mark for
    :func:`restore_registry`)."""
    with _registry_lock:
        return list(_registry)


def restore_registry(mark: List["Metric"]) -> int:
    """Unregister every metric created since ``mark`` (order and label
    state of surviving metrics untouched). Returns how many were
    dropped — the scoped reset a test suite needs so ``_registry``
    doesn't grow forever and one test's labelsets don't bleed into the
    next test's Prometheus snapshot."""
    keep = set(map(id, mark))
    with _registry_lock:
        before = len(_registry)
        _registry[:] = [m for m in _registry if id(m) in keep]
        return before - len(_registry)


@contextlib.contextmanager
def isolated_registry():
    """Context manager: metrics registered inside the block are
    unregistered on exit."""
    mark = registry_snapshot()
    try:
        yield
    finally:
        restore_registry(mark)


# ---- /metrics HTTP endpoint ------------------------------------------
_server_lock = threading.Lock()
_metrics_server = None
_metrics_thread = None


def serve_prometheus(port: int = 0, host: Optional[str] = None) -> int:
    """Start a /metrics HTTP endpoint; returns the bound port.

    Close-previous semantics: a second call stops the earlier server
    first (historically the module global was silently overwritten,
    leaking the old thread and socket). ``host`` defaults to
    ``RAY_TPU_TORCH_METRICS_BIND_HOST`` (else loopback); bind ``0.0.0.0`` to
    let an external Prometheus scrape the process."""
    global _metrics_server, _metrics_thread
    import threading as _t
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = export_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    if host is None:
        host = os.environ.get("RAY_TPU_TORCH_METRICS_BIND_HOST", "127.0.0.1")
    stop_prometheus()
    with _server_lock:
        _metrics_server = ThreadingHTTPServer((host, port), Handler)
        _metrics_thread = _t.Thread(
            target=_metrics_server.serve_forever,
            name="prometheus-metrics", daemon=True)
        _metrics_thread.start()
        return _metrics_server.server_address[1]


def stop_prometheus(timeout: float = 5.0) -> bool:
    """Stop the endpoint started by :func:`serve_prometheus` (close the
    socket, join the thread). Returns True if a server was running."""
    global _metrics_server, _metrics_thread
    with _server_lock:
        server, thread = _metrics_server, _metrics_thread
        _metrics_server = _metrics_thread = None
    if server is None:
        return False
    try:
        server.shutdown()
        server.server_close()
    except Exception:
        pass
    if thread is not None:
        thread.join(timeout)
    return True


# ---- periodic fleet reporter -----------------------------------------
#: one ACTIVE reporter per process: the registry is process-global, so
#: colocated runtimes (head mode hosts controller + node manager +
#: driver in one process) must not each ship the same snapshot — the
#: fleet merge would multiply every sample by the number of roles.
#: The highest-precedence role claims the process; ties go to the
#: newest claimant (a restarted session supersedes a stale reporter).
_ROLE_RANK = {"controller": 0, "node": 1, "worker": 2, "driver": 3}
_active_reporter_lock = threading.Lock()
_active_reporter: Optional["MetricsReporter"] = None


def _claim_reporter(rep: "MetricsReporter") -> bool:
    global _active_reporter
    with _active_reporter_lock:
        cur = _active_reporter
        rank = _ROLE_RANK.get(rep.origin.get("role"), 2)
        if cur is None or not cur.active or \
                rank >= _ROLE_RANK.get(cur.origin.get("role"), 2):
            if cur is not None:
                cur.active = False
            _active_reporter = rep
            return True
        return False


class MetricsReporter:
    """Ships this process's metric snapshots to the controller.

    Fire-and-forget like the flight recorder's flush: ``send`` enqueues
    a ``METRIC_REPORT`` payload into the process's async flusher (the
    reliable layer gives it exactly-once-effect at the controller; a
    chaos drop costs a retransmit, never a stall). Reports supersede
    each other — a snapshot is cumulative — so before shipping a new
    one the reporter asks ``pending_drop`` to abandon in-flight older
    reports beyond a small bound (drop-OLDEST, counted in
    ``runtime_metric_reports_dropped_total``): a dead link can never
    grow the retransmit ring or block a task."""

    #: in-flight (unacked) reports kept alive; older ones are dropped
    MAX_PENDING = 4

    def __init__(self, send: Callable[[dict], None], origin: Dict,
                 interval_s: float = 1.0, enabled: bool = True,
                 pending_drop: Optional[Callable[[int], int]] = None):
        self._send = send
        self.origin = dict(origin)
        self._interval = interval_s
        self.enabled = enabled
        self._pending_drop = pending_drop
        self._seq = 0
        self._lock = threading.Lock()
        self._last = 0.0
        self.dropped = 0
        self._dropped_metric = None
        #: False when another (higher-precedence or newer) reporter in
        #: this process owns the registry — see _claim_reporter
        self.active = _claim_reporter(self)

    def _count_drop(self, n: int, reason: str) -> None:
        self.dropped += n
        m = self._dropped_metric
        if m is None:
            try:
                from ray_tpu_torch.core.metric_defs import runtime_metrics
                m = self._dropped_metric = \
                    runtime_metrics().metric_reports_dropped
            except Exception:
                return
        try:
            m.inc(n, tags={"reason": reason})
        except Exception:
            pass

    def report_now(self) -> Optional[dict]:
        """Build and ship one snapshot report; returns the payload (or
        None when disabled / passive / the send path is down). Never
        raises."""
        if not self.enabled or not self.active:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._last = time.monotonic()
        if self._pending_drop is not None:
            try:
                stale = self._pending_drop(self.MAX_PENDING - 1)
                if stale:
                    self._count_drop(stale, "superseded")
            except Exception:
                pass
        payload = {"origin": self.origin, "seq": seq,
                   "ts": time.time(), "metrics": export_snapshot()}
        try:
            self._send(payload)
        except Exception:
            # boot/shutdown window — metrics are observability; losing
            # a report must not hurt the process
            self._count_drop(1, "send_failed")
            return None
        return payload

    def release(self) -> None:
        """Process-shutdown hook: give up the process claim so a later
        runtime in this process (or a colocated lower-precedence one)
        can report again."""
        global _active_reporter
        self.active = False
        with _active_reporter_lock:
            if _active_reporter is self:
                _active_reporter = None

    def maybe_report(self, now: Optional[float] = None) -> None:
        """Interval-gated report (call from any periodic loop; cheap
        no-op inside the interval)."""
        if not self.enabled or not self.active:
            return
        if (now or time.monotonic()) - self._last >= self._interval:
            self.report_now()


def make_reporter(send, origin: Dict, config,
                  pending_drop=None) -> MetricsReporter:
    """Build a process's reporter from config knobs."""
    return MetricsReporter(
        send, origin,
        interval_s=getattr(config, "metrics_report_interval_ms",
                           1000) / 1000.0,
        enabled=getattr(config, "enable_metrics_report", True),
        pending_drop=pending_drop)
