"""Cluster-wide metrics plane: fleet aggregation of process snapshots.

Reference: the per-node OpenCensus pipeline behind ``metric_defs.cc`` —
every Ray process exports to its node's Prometheus endpoint and an
external Prometheus server does the fleet math. Here the controller IS
the aggregation point: every process periodically ships a
``METRIC_REPORT`` (MRT) snapshot of its whole metric registry
(``util/metrics.py::export_snapshot`` — cumulative counters, last-value
gauges, histogram bucket vectors) over the PR-2 reliable layer
(exactly-once-effect, fire-and-forget for the producer), and this
module merges them keyed ``(node, pid, role)`` into bounded
fixed-interval time-series rings per ``(metric, labelset)``.

Derived series come straight from the rings:

- **per-window rates** for counters (fleet tokens/s, retransmits/s)
  from slot-to-slot deltas, reset-corrected so a restarted process
  (counter back to 0) adds instead of subtracting;
- **fleet histogram quantiles** from summed bucket *deltas* across
  origins (fleet TTFT p50/p99 — the classic
  ``histogram_quantile(sum by (le) (rate(...)))`` shape);
- **latest-value fleet gauges** (queue depths, occupancy, bubble
  fraction, MFU).

Surfaces: one cluster ``/metrics`` Prometheus endpoint on the dashboard
head (origin labels on every sample), the ``/api/v0/metrics`` catalog +
``/api/v0/metrics/query`` JSON API, Chrome-trace counter tracks for
``/timeline``, and the ``ray-tpu top`` fleet view (``tools/top.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: labels stamped on every aggregated sample naming the origin process
ORIGIN_LABELS = ("node", "pid", "role")

#: histogram quantile aggregations accepted by :meth:`MetricsPlane.query`
_QUANTILE_AGGS = {"p50": 0.5, "p90": 0.9, "p95": 0.95, "p99": 0.99}


def bucket_quantile(bounds: Sequence[float], counts: Sequence[float],
                    q: float) -> Optional[float]:
    """Quantile from a histogram bucket-count vector.

    ``counts`` has ``len(bounds) + 1`` entries (the last is the +Inf
    overflow bucket). Linear interpolation inside the winning bucket,
    Prometheus ``histogram_quantile`` style; the +Inf bucket clamps to
    the highest finite bound. Returns None for an empty histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = float(sum(counts))
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):
                return float(bounds[-1]) if bounds else None
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * frac
    return float(bounds[-1]) if bounds else None


class SeriesRing:
    """Bounded fixed-interval time-series ring.

    Samples land in the slot ``floor(ts / interval)`` (last write wins
    within a slot — snapshots are cumulative, the freshest supersedes);
    only the most recent ``slots`` slots are kept. Out-of-order
    arrivals (a retransmitted older report) write into their own older
    slot and never corrupt newer ones."""

    __slots__ = ("interval", "slots", "_d")

    def __init__(self, interval_s: float = 1.0, slots: int = 600):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.interval = float(interval_s)
        self.slots = int(slots)
        self._d: Dict[int, Any] = {}

    def put(self, ts: float, value: Any) -> None:
        self._d[int(ts // self.interval)] = value
        while len(self._d) > self.slots:
            del self._d[min(self._d)]

    def __len__(self) -> int:
        return len(self._d)

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, Any]]:
        """Sorted ``(slot_start_ts, value)`` pairs, optionally limited
        to the trailing ``window_s`` seconds before ``now``."""
        items = sorted(self._d.items())
        if window_s is not None:
            if now is None:
                import time
                now = time.time()
            lo = (now - window_s) // self.interval
            items = [kv for kv in items if kv[0] >= lo]
        return [(k * self.interval, v) for k, v in items]

    def latest(self) -> Optional[Tuple[float, Any]]:
        if not self._d:
            return None
        k = max(self._d)
        return (k * self.interval, self._d[k])


class _Series:
    """One origin's one labelset of one metric: the ring plus the
    counter-reset correction state (a restarted process starts its
    cumulative counters back at zero — the merge must treat that as
    continuation, not a negative rate)."""

    __slots__ = ("kind", "labels", "origin", "ring",
                 "last_raw", "base", "last_sum_raw", "sum_base")

    def __init__(self, kind: str, labels: Tuple, origin: Tuple,
                 interval_s: float, slots: int):
        self.kind = kind
        self.labels = labels              # ((k, v), ...) incl. origin
        self.origin = origin              # (node, pid, role)
        self.ring = SeriesRing(interval_s, slots)
        self.last_raw: Any = None         # float | List[float]
        self.base: Any = None
        self.last_sum_raw = 0.0
        self.sum_base = 0.0

    def update_counter(self, ts: float, raw: float) -> None:
        if self.last_raw is None:
            self.base = 0.0
        elif raw < self.last_raw:
            self.base += self.last_raw    # process restarted: carry on
        self.last_raw = raw
        self.ring.put(ts, self.base + raw)

    def update_gauge(self, ts: float, raw: float) -> None:
        self.ring.put(ts, float(raw))

    def update_histogram(self, ts: float, counts: List[float],
                         total: float) -> None:
        if self.last_raw is None or len(self.last_raw) != len(counts):
            self.base = [0.0] * len(counts)
            self.sum_base = 0.0
        elif sum(counts) < sum(self.last_raw):
            self.base = [b + r for b, r in zip(self.base, self.last_raw)]
            self.sum_base += self.last_sum_raw
        self.last_raw = list(counts)
        self.last_sum_raw = float(total)
        self.ring.put(ts, (tuple(b + c for b, c in
                                 zip(self.base, counts)),
                           self.sum_base + total))


def _label_tuple(pairs: Iterable) -> Tuple:
    return tuple(sorted((str(k), str(v)) for k, v in pairs))


class MetricsPlane:
    """Controller-side fleet aggregator. Thread-safe: MRT batches land
    on the controller loop thread, the controller's own reporter fires
    from the health thread, and the dashboard's HTTP threads query."""

    #: hard cap on distinct (metric, labelset, origin) series; overflow
    #: is counted (``stats["series_dropped"]``), never unbounded memory
    MAX_SERIES = 8192

    def __init__(self, interval_s: float = 1.0, slots: int = 600):
        self._lock = threading.Lock()
        self.interval_s = float(interval_s)
        self.slots = int(slots)
        #: (node, pid, role) -> {"seq": int, "ts": float}
        self._origins: Dict[Tuple, Dict] = {}
        #: metric name -> {"type", "desc", "bounds"}
        self._meta: Dict[str, Dict] = {}
        #: (name, labels) -> _Series
        self._series: Dict[Tuple, _Series] = {}
        self.stats: Dict[str, int] = {"reports": 0, "stale": 0,
                                      "series_dropped": 0}

    @classmethod
    def from_config(cls, config) -> "MetricsPlane":
        return cls(
            interval_s=getattr(config, "metrics_ring_interval_s", 1.0),
            slots=getattr(config, "metrics_ring_slots", 600))

    # ---------------------------------------------------------- ingest
    def ingest(self, payload: Dict) -> bool:
        """Merge one METRIC_REPORT payload. Returns False for stale or
        malformed reports (seq at or below the origin's last seen —
        exactly-once-effect even if the reliable layer's dedup missed a
        replay, e.g. across a controller restart)."""
        try:
            origin = payload["origin"]
            okey = (str(origin.get("node")), int(origin.get("pid", 0)),
                    str(origin.get("role")))
            seq = int(payload.get("seq", 0))
            ts = float(payload.get("ts", 0.0))
            metrics = payload.get("metrics") or []
        except Exception:
            return False
        opairs = tuple(zip(ORIGIN_LABELS, map(str, okey)))
        with self._lock:
            ent = self._origins.get(okey)
            if ent is not None and seq <= ent["seq"]:
                self.stats["stale"] += 1
                return False
            self._origins[okey] = {"seq": seq, "ts": ts}
            self.stats["reports"] += 1
            for m in metrics:
                try:
                    self._ingest_metric_locked(m, okey, opairs, ts)
                except Exception:
                    continue
        return True

    def _ingest_metric_locked(self, m: Dict, okey: Tuple,
                              opairs: Tuple, ts: float) -> None:
        name, kind = m["name"], m["type"]
        meta = self._meta.setdefault(
            name, {"type": kind, "desc": m.get("desc", ""),
                   "bounds": m.get("bounds")})
        if m.get("desc") and not meta["desc"]:
            meta["desc"] = m["desc"]
        for sample in m.get("samples", ()):
            labels = _label_tuple(list(sample[0]) + list(opairs))
            skey = (name, labels)
            s = self._series.get(skey)
            if s is None:
                if len(self._series) >= self.MAX_SERIES:
                    self.stats["series_dropped"] += 1
                    continue
                s = self._series[skey] = _Series(
                    kind, labels, okey, self.interval_s, self.slots)
            if kind == "counter":
                s.update_counter(ts, float(sample[1]))
            elif kind == "gauge":
                s.update_gauge(ts, float(sample[1]))
            elif kind == "histogram":
                s.update_histogram(ts, [float(c) for c in sample[1]],
                                   float(sample[2]))

    # --------------------------------------------------------- queries
    def catalog(self) -> List[Dict]:
        """One row per metric name: type, help, series count, origins
        contributing, and (for scalars) the fleet total/latest — the
        ``/api/v0/metrics`` payload."""
        with self._lock:
            per_name: Dict[str, List[_Series]] = {}
            for (name, _), s in self._series.items():
                per_name.setdefault(name, []).append(s)
            rows = []
            for name in sorted(self._meta):
                meta = self._meta[name]
                series = per_name.get(name, [])
                origins = sorted({s.origin for s in series})
                row = {"name": name, "type": meta["type"],
                       "description": meta["desc"],
                       "series": len(series),
                       "origins": [list(o) for o in origins]}
                if meta["type"] in ("counter", "gauge"):
                    latest = [s.ring.latest() for s in series]
                    vals = [v for v in latest if v is not None]
                    if vals:
                        row["fleet_total" if meta["type"] == "counter"
                            else "fleet_sum"] = sum(v for _, v in vals)
                rows.append(row)
            return rows

    def latest_samples(self, name: str) -> List[Dict]:
        """Every series' freshest value for one metric (origin labels
        included)."""
        out = []
        with self._lock:
            for (n, labels), s in self._series.items():
                if n != name:
                    continue
                latest = s.ring.latest()
                if latest is None:
                    continue
                ts, v = latest
                row = {"labels": dict(labels), "ts": ts}
                if s.kind == "histogram":
                    row["counts"] = list(v[0])
                    row["sum"] = v[1]
                    row["count"] = sum(v[0])
                else:
                    row["value"] = v
                out.append(row)
        out.sort(key=lambda r: sorted(r["labels"].items()))
        return out

    def query(self, name: str, window_s: float = 60.0,
              agg: Optional[str] = None,
              now: Optional[float] = None) -> Dict:
        """Fleet-aggregated time series for one metric over the
        trailing window.

        ``agg`` by metric type — counters: ``rate`` (default; summed
        per-slot delta / slot width) or ``total``; gauges: ``sum``
        (default) / ``avg`` / ``max`` / ``min``; histograms: ``p50`` /
        ``p90`` / ``p95`` / ``p99`` (bucket-delta quantiles), ``rate``
        (observations/s) or ``mean``. Returns ``{"name", "agg",
        "interval_s", "points": [[ts, value], ...]}``."""
        if now is None:
            import time
            now = time.time()
        with self._lock:
            meta = self._meta.get(name)
            if meta is None:
                return {"name": name, "agg": agg, "error": "unknown",
                        "interval_s": self.interval_s, "points": []}
            kind = meta["type"]
            if agg is None:
                agg = {"counter": "rate", "gauge": "sum",
                       "histogram": "p50"}[kind]
            series = [s for (n, _), s in self._series.items()
                      if n == name]
            # one extra leading slot so the first windowed slot has a
            # predecessor to delta against
            pts = [s.ring.points(window_s + self.interval_s, now)
                   for s in series]
        slot_vals: Dict[float, List[float]] = {}
        for p in pts:
            if kind == "gauge":
                for ts, v in p:
                    slot_vals.setdefault(ts, []).append(v)
                continue
            for (ts0, v0), (ts1, v1) in zip(p, p[1:]):
                dt = ts1 - ts0
                if dt <= 0:
                    continue
                if kind == "counter":
                    val = {"rate": (v1 - v0) / dt, "total": v1}[
                        agg if agg in ("rate", "total") else "rate"]
                    slot_vals.setdefault(ts1, []).append(val)
                else:  # histogram: per-slot bucket/sum deltas
                    dc = [b - a for a, b in zip(v0[0], v1[0])]
                    dsum = v1[1] - v0[1]
                    slot_vals.setdefault(ts1, []).append(
                        (dc, dsum, dt))  # type: ignore[arg-type]
        lo = now - window_s
        points: List[List[float]] = []
        for ts in sorted(slot_vals):
            if ts < lo:
                continue
            vals = slot_vals[ts]
            if kind == "histogram":
                merged = None
                total_sum = 0.0
                dt = self.interval_s
                for dc, dsum, d in vals:  # type: ignore[misc]
                    merged = dc if merged is None else \
                        [a + b for a, b in zip(merged, dc)]
                    total_sum += dsum
                    dt = d
                n_obs = sum(merged) if merged else 0.0
                if agg in _QUANTILE_AGGS:
                    v = bucket_quantile(meta.get("bounds") or [],
                                        merged or [],
                                        _QUANTILE_AGGS[agg])
                    if v is None:
                        continue
                elif agg == "rate":
                    v = n_obs / dt
                elif agg == "mean":
                    if n_obs <= 0:
                        continue
                    v = total_sum / n_obs
                else:
                    raise ValueError(f"bad histogram agg {agg!r}")
                points.append([ts, v])
                continue
            if kind == "gauge":
                if agg == "sum":
                    v = sum(vals)
                elif agg == "avg":
                    v = sum(vals) / len(vals)
                elif agg == "max":
                    v = max(vals)
                elif agg == "min":
                    v = min(vals)
                else:
                    raise ValueError(f"bad gauge agg {agg!r}")
            else:
                v = sum(vals)
            points.append([ts, v])
        return {"name": name, "agg": agg,
                "interval_s": self.interval_s, "points": points}

    # ------------------------------------------------- Prometheus text
    def prometheus_text(self) -> str:
        """The whole fleet in Prometheus exposition format — the single
        cluster scrape target. Every sample carries its origin labels
        (``node``/``pid``/``role``), so per-process drill-down is a
        label matcher away."""
        from ray_tpu_torch.util.metrics import _fmt_labels
        with self._lock:
            per_name: Dict[str, List[_Series]] = {}
            for (name, _), s in self._series.items():
                per_name.setdefault(name, []).append(s)
            lines: List[str] = []
            for name in sorted(per_name):
                meta = self._meta.get(name) or {}
                if meta.get("desc"):
                    lines.append(f"# HELP {name} {meta['desc']}")
                lines.append(
                    f"# TYPE {name} {meta.get('type', 'untyped')}")
                for s in sorted(per_name[name],
                                key=lambda s: s.labels):
                    latest = s.ring.latest()
                    if latest is None:
                        continue
                    _, v = latest
                    if s.kind == "histogram":
                        bounds = meta.get("bounds") or []
                        cum = 0.0
                        for bound, c in zip(bounds, v[0]):
                            cum += c
                            lines.append(
                                f"{name}_bucket"
                                f"{_fmt_labels(s.labels, le=bound)} "
                                f"{cum}")
                        cum += v[0][-1] if len(v[0]) > len(bounds) \
                            else 0.0
                        lines.append(
                            f"{name}_bucket"
                            f'{_fmt_labels(s.labels, le="+Inf")} {cum}')
                        lines.append(
                            f"{name}_count{_fmt_labels(s.labels)} "
                            f"{cum}")
                        lines.append(
                            f"{name}_sum{_fmt_labels(s.labels)} "
                            f"{v[1]}")
                    else:
                        lines.append(
                            f"{name}{_fmt_labels(s.labels)} {v}")
        return "\n".join(lines) + "\n"

    # ------------------------------------------- Chrome counter tracks
    def chrome_counters(self, names: Optional[Sequence[str]] = None,
                        window_s: Optional[float] = None,
                        now: Optional[float] = None) -> List[Dict]:
        """Chrome-trace counter events (``"ph": "C"``) for the
        dashboard ``/timeline``: tokens/s, queue depth, occupancy et al
        rendered as curves alongside the flight recorder's spans. One
        counter track per (metric, origin process); counter metrics
        plot their per-slot rate, gauges their value."""
        if names is None:
            names = DEFAULT_TIMELINE_COUNTERS
        out: List[Dict] = []
        with self._lock:
            series = [((n, labels), s)
                      for (n, labels), s in self._series.items()
                      if n in names and s.kind != "histogram"]
            pts = [(key, s.kind, s.origin,
                    s.ring.points(window_s, now)) for key, s in series]
        for (name, _labels), kind, origin, p in pts:
            proc = f"{origin[2]}:{origin[1]}"
            track = name
            if kind == "counter":
                track += "/s"
                p = [(ts1, (v1 - v0) / (ts1 - ts0))
                     for (ts0, v0), (ts1, v1) in zip(p, p[1:])
                     if ts1 > ts0]
            for ts, v in p:
                out.append({"name": track, "cat": "metric", "ph": "C",
                            "ts": ts * 1e6, "pid": 0, "tid": 0,
                            "proc": proc,
                            "args": {"value": round(float(v), 4)}})
        return out

    # ----------------------------------------------------- fleet view
    def _origin_latest(self, name: str) -> Dict[Tuple, float]:
        """origin -> summed latest value across that origin's labelsets
        of ``name`` (lock held by caller)."""
        out: Dict[Tuple, float] = {}
        for (n, _), s in self._series.items():
            if n != name or s.kind == "histogram":
                continue
            latest = s.ring.latest()
            if latest is not None:
                out[s.origin] = out.get(s.origin, 0.0) + latest[1]
        return out

    def _origin_rate(self, name: str, window_s: float,
                     now: float) -> Dict[Tuple, float]:
        out: Dict[Tuple, float] = {}
        for (n, _), s in self._series.items():
            if n != name or s.kind != "counter":
                continue
            p = s.ring.points(window_s, now)
            if len(p) >= 2 and p[-1][0] > p[0][0]:
                r = (p[-1][1] - p[0][1]) / (p[-1][0] - p[0][0])
                out[s.origin] = out.get(s.origin, 0.0) + r
        return out

    def _origin_quantiles(self, name: str, window_s: float, now: float,
                          qs: Sequence[float]) -> Dict[Tuple, List]:
        bounds = (self._meta.get(name) or {}).get("bounds") or []
        acc: Dict[Tuple, List[float]] = {}
        for (n, _), s in self._series.items():
            if n != name or s.kind != "histogram":
                continue
            p = s.ring.points(window_s, now)
            if not p:
                continue
            first, last = p[0][1], p[-1][1]
            delta = [b - a for a, b in zip(first[0], last[0])] \
                if len(p) >= 2 else list(last[0])
            cur = acc.get(s.origin)
            acc[s.origin] = delta if cur is None else \
                [a + b for a, b in zip(cur, delta)]
        return {o: [bucket_quantile(bounds, c, q) for q in qs]
                for o, c in acc.items()}

    def fleet_summary(self, window_s: float = 30.0,
                      now: Optional[float] = None) -> Dict:
        """The ``ray-tpu top`` payload: one row per origin process with
        the fleet's key signals, plus fleet-level aggregates."""
        if now is None:
            import time
            now = time.time()
        with self._lock:
            origins = dict(self._origins)
            tok_rate = self._origin_rate(
                "serve_engine_tokens_total", window_s, now)
            tasks_rate = self._origin_rate(
                "runtime_tasks_finished_total", window_s, now)
            retx = self._origin_latest(
                "runtime_reliable_retransmits_total")
            stalls = self._origin_latest(
                "runtime_stream_credit_stall_seconds_total")
            qdepth = self._origin_latest("serve_engine_queue_depth")
            train_tps = self._origin_latest("train_tokens_per_s")
            mfu = self._origin_latest("train_mfu_pct")
            bubble = self._origin_latest("pipeline_bubble_fraction")
            mbx: Dict[Tuple, float] = {}
            for (n, _), s in self._series.items():
                if n != "pipeline_stage_mailbox_depth":
                    continue
                latest = s.ring.latest()
                if latest is not None:
                    mbx[s.origin] = max(mbx.get(s.origin, 0.0),
                                        latest[1])
            ttft = self._origin_quantiles(
                "serve_engine_ttft_seconds", window_s, now,
                (0.5, 0.99))
            reports_dropped = self._origin_latest(
                "runtime_metric_reports_dropped_total")
        rows = []
        for okey in sorted(origins):
            node, pid, role = okey
            q = ttft.get(okey, (None, None))
            rows.append({
                "node": node, "pid": pid, "role": role,
                "last_report_s": round(max(0.0, now -
                                           origins[okey]["ts"]), 1),
                "tokens_per_s": round(tok_rate.get(okey, 0.0), 1),
                "train_tokens_per_s": round(train_tps.get(okey, 0.0),
                                            1),
                "tasks_per_s": round(tasks_rate.get(okey, 0.0), 2),
                "queue_depth": qdepth.get(okey),
                "ttft_p50_ms": None if q[0] is None
                else round(q[0] * 1e3, 1),
                "ttft_p99_ms": None if q[1] is None
                else round(q[1] * 1e3, 1),
                "bubble": bubble.get(okey),
                "mfu_pct": mfu.get(okey),
                "mailbox_depth": mbx.get(okey),
                "retransmits": retx.get(okey, 0.0),
                "credit_stall_s": round(stalls.get(okey, 0.0), 2),
                "reports_dropped": reports_dropped.get(okey, 0.0),
            })
        fleet = {
            "processes": len(rows),
            "tokens_per_s": round(sum(r["tokens_per_s"]
                                      for r in rows), 1),
            "train_tokens_per_s": round(
                sum(r["train_tokens_per_s"] for r in rows), 1),
            "tasks_per_s": round(sum(r["tasks_per_s"] for r in rows),
                                 2),
            "retransmits": sum(r["retransmits"] for r in rows),
            "credit_stall_s": round(sum(r["credit_stall_s"]
                                        for r in rows), 2),
        }
        return {"window_s": window_s, "ts": now, "rows": rows,
                "fleet": fleet}


#: counter tracks /timeline renders by default (next to the spans)
DEFAULT_TIMELINE_COUNTERS = (
    "serve_engine_tokens_total", "serve_engine_queue_depth",
    "serve_engine_tokens_per_s", "train_tokens_per_s",
    "pipeline_stage_mailbox_depth", "pipeline_bubble_fraction",
    "runtime_scheduler_queued_tasks", "runtime_tasks_finished_total",
)
