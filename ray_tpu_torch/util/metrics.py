"""Metrics: Counter / Gauge / Histogram in a process-local registry, and
the Prometheus text and structured snapshot exports of it.

The port's copy of ``ray_tpu/util/metrics.py``. The periodic fleet
reporter (``MetricsReporter``) and the ``/metrics`` HTTP endpoint ride
the distributed runtime, which the port does not have yet; a caller
reads :func:`export_prometheus` or :func:`export_snapshot` directly.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

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
