"""State API: queryable live cluster state.

Reference: ``python/ray/util/state/api.py`` (``list_actors/tasks/
objects/nodes/placement_groups/jobs``, ``summarize_*``) served by
``dashboard/state_aggregator.py:141``; here the controller's state
tables answer directly (single control plane, no fan-out needed).
Filters are ``(key, predicate, value)`` tuples with ``=``/``!=``, as in
the reference CLI.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.global_state import global_worker

Filter = Tuple[str, str, Any]


def _query(what: str, filters: Optional[List[Filter]] = None,
           limit: int = 1000, detail: bool = False) -> List[dict]:
    rows = global_worker().state_query(what)
    if not isinstance(rows, list):
        return rows
    for key, op, value in (filters or []):
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"Unsupported predicate {op!r}")
    return rows[:limit]


def list_nodes(filters=None, limit: int = 1000, **kw) -> List[dict]:
    return _query("nodes", filters, limit)


def list_actors(filters=None, limit: int = 1000, **kw) -> List[dict]:
    return _query("actors", filters, limit)


def list_tasks(filters=None, limit: int = 1000, **kw) -> List[dict]:
    return _query("tasks", filters, limit)


def list_objects(filters=None, limit: int = 1000, **kw) -> List[dict]:
    return _query("objects", filters, limit)


def list_placement_groups(filters=None, limit: int = 1000,
                          **kw) -> List[dict]:
    return _query("placement_groups", filters, limit)


def list_jobs(filters=None, limit: int = 1000, **kw) -> List[dict]:
    return _query("jobs", filters, limit)


def list_workers(filters=None, limit: int = 1000, **kw) -> List[dict]:
    # Workers are surfaced per node (the controller tracks them there).
    out = []
    for n in _query("nodes", None, limit):
        out.append({"node_id": n["node_id"],
                    "num_workers": n["num_workers"]})
    return out


def list_task_events(task_id: Optional[str] = None, filters=None,
                     limit: int = 100_000) -> List[dict]:
    """Merged flight-recorder event stream (core/events.py), oldest
    first. ``task_id`` (hex) narrows to one task's causal timeline;
    ``filters`` apply the standard ``(key, op, value)`` predicates
    (keys: ``ev``, ``proc``, ``trace``, ``span``, ...)."""
    w = global_worker()
    # ship this process's buffered events first so the snapshot
    # includes what the caller just did
    try:
        w.flush_events()
    except Exception:
        pass
    rows = w.state_query("task_events")
    if not isinstance(rows, list):
        return rows
    if task_id is not None:
        rows = [r for r in rows if r.get("task") == task_id]
    for key, op, value in (filters or []):
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"Unsupported predicate {op!r}")
    return rows[-limit:]


def _fresh_local_report(w) -> None:
    """Ship this process's current metric snapshot ahead of a plane
    query (both ride the same FIFO link, so the report lands first —
    the snapshot the query sees includes what the caller just did)."""
    try:
        w.metrics_reporter.report_now()
    except Exception:
        pass


def list_metrics() -> List[dict]:
    """The fleet metrics catalog (core/metrics_plane.py): one row per
    metric name with type, help text, series count, contributing
    origins, and the fleet total/sum for scalars."""
    w = global_worker()
    _fresh_local_report(w)
    return w.state_query("metrics")


def query_metric(name: str, window_s: float = 60.0,
                 agg: Optional[str] = None) -> Dict[str, Any]:
    """Fleet-aggregated time series for one metric over the trailing
    window (see :meth:`MetricsPlane.query` for the ``agg`` table —
    counter rates, gauge sum/avg/max/min, histogram p50..p99 from
    bucket deltas)."""
    w = global_worker()
    _fresh_local_report(w)
    return w.state_query(
        "metrics_query",
        params={"name": name, "window_s": window_s, "agg": agg})


def fleet_metrics(window_s: float = 30.0) -> Dict[str, Any]:
    """The ``ray-tpu top`` snapshot: per-process rows (tokens/s, queue
    depth, TTFT quantiles, bubble, retransmits, credit stalls) plus
    fleet aggregates."""
    w = global_worker()
    _fresh_local_report(w)
    return w.state_query(
        "metrics_fleet", params={"window_s": window_s})


def list_requests(limit: int = 50) -> List[dict]:
    """Tail-sampled serve request traces at the controller, newest
    first (serve/request_trace.py): one summary row per request —
    request_id, terminal status, duration, SLO trips, and a per-phase
    breakdown. Only slow / failed / 1-in-N requests ship spans, so
    this is the interesting tail, not all traffic."""
    return global_worker().state_query(
        "requests", limit=limit)


def get_request_trace(request_id: str) -> Optional[dict]:
    """Full waterfall for one traced request — every recorded span
    (phase, t0, t1, attrs) sorted by start time, plus SLO trips and
    routing metadata. None when the id never shipped (fast request
    outside the sample, or the trace aged out of the ring)."""
    rows = global_worker().state_query(
        "request_trace", params={"request_id": request_id})
    return rows[0] if rows else None


def summarize_task_latency() -> Dict[str, Any]:
    """Per-task-name latency summary from the flight recorder:
    scheduling delay (SUBMITTED→RUNNING) and execution time
    (RUNNING→FINISHED/FAILED), with count / mean / max in seconds —
    the per-stage signal overlap tuning needs (cf. Podracer /
    MindSpeed RL: rollout→train dataflows are tuned by stage latency,
    not end-to-end wall time)."""
    events = list_task_events()
    per_task: Dict[str, Dict[str, float]] = {}
    names: Dict[str, str] = {}
    for e in events:
        t = e.get("task")
        if t is None:
            continue
        slot = per_task.setdefault(t, {})
        ev = e.get("ev")
        if ev in ("SUBMITTED", "RUNNING", "FINISHED", "FAILED"):
            # first sighting wins for SUBMITTED/RUNNING (replays keep
            # the original submit), last wins for the terminal event
            if ev in ("FINISHED", "FAILED") or ev not in slot:
                slot[ev] = e.get("ts", 0.0)
        if e.get("name"):
            names[t] = e["name"]

    def agg(samples: List[float]) -> Dict[str, float]:
        return {"count": len(samples),
                "mean_s": sum(samples) / len(samples),
                "max_s": max(samples)}

    sched: Dict[str, List[float]] = {}
    execd: Dict[str, List[float]] = {}
    failed: Counter = Counter()
    for t, slot in per_task.items():
        name = names.get(t, "?")
        if "SUBMITTED" in slot and "RUNNING" in slot:
            sched.setdefault(name, []).append(
                max(0.0, slot["RUNNING"] - slot["SUBMITTED"]))
        end = slot.get("FINISHED", slot.get("FAILED"))
        if end is not None and "RUNNING" in slot:
            execd.setdefault(name, []).append(
                max(0.0, end - slot["RUNNING"]))
        if "FAILED" in slot:
            failed[name] += 1
    out: Dict[str, Any] = {}
    for name in sorted(set(sched) | set(execd)):
        out[name] = {}
        if name in sched:
            out[name]["scheduling"] = agg(sched[name])
        if name in execd:
            out[name]["execution"] = agg(execd[name])
        if failed.get(name):
            out[name]["failed"] = failed[name]
    return out


def summarize_tasks() -> Dict[str, Any]:
    by_state: Counter = Counter()
    by_name: Dict[str, Counter] = {}
    for t in list_tasks(limit=100_000):
        state = t.get("state", "UNKNOWN")
        by_state[state] += 1
        name = t.get("name", "?")
        by_name.setdefault(name, Counter())[state] += 1
    return {"total": sum(by_state.values()),
            "by_state": dict(by_state),
            "by_func_name": {k: dict(v) for k, v in by_name.items()}}


def summarize_actors() -> Dict[str, Any]:
    by_state: Counter = Counter()
    for a in list_actors(limit=100_000):
        by_state[a.get("state", "UNKNOWN")] += 1
    return {"total": sum(by_state.values()), "by_state": dict(by_state)}


def summarize_objects() -> Dict[str, Any]:
    objs = list_objects(limit=100_000)
    return {"total": len(objs),
            "total_size_bytes": sum(o.get("size") or 0 for o in objs),
            "inline": sum(1 for o in objs if o.get("inline")),
            "errors": sum(1 for o in objs if o.get("has_error"))}


def get_log(node_id: Optional[str] = None, pid: Optional[int] = None,
            tail: int = 100) -> List[str]:
    """Tail worker logs from the session dir (reference ``get_log``)."""
    import glob
    import os
    w = global_worker()
    session_dir = getattr(w, "session_dir", None)
    if session_dir is None:
        return []
    pattern = os.path.join(session_dir, "logs", "worker-*.out")
    lines: List[str] = []
    import re
    for path in sorted(glob.glob(pattern)):
        if pid is not None:
            nums = re.findall(r"\d+", os.path.basename(path))
            if str(pid) not in nums:
                continue
        with open(path, errors="replace") as f:
            lines.extend(f"{os.path.basename(path)}: {ln.rstrip()}"
                         for ln in f.readlines()[-tail:])
    return lines[-tail:]
