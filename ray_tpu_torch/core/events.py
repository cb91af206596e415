"""Task-event flight recorder: causal traces for every control hop.

Reference: the GcsTaskManager task-event pipeline
(``src/ray/gcs/gcs_server/gcs_task_manager.cc`` fed by each worker's
``task_event_buffer.cc``) — every process appends structured task
lifecycle events into a bounded local buffer that is periodically
flushed to the head, where ``ray list tasks`` / the dashboard timeline
read them. Here the same layering, extended with **causal trace ids**:

- every control message that moves a task between processes
  (DSP/ACL/ASG/DON/CAC/RES/SIT/SEF/SCR) carries a propagated
  ``(trace id, parent span)`` pair (``TaskSpec.trace`` on spec-carrying
  messages, a ``"trace"`` payload key on the rest), so one logical task
  graph shares one trace id across every process it touches;
- each process owns a :class:`FlightRecorder` — a lock-cheap bounded
  ring (drop-oldest on overflow, counted in the
  ``runtime_events_dropped_total`` metric) flushed to the controller as
  ``TASK_EVENTS`` messages riding the reliable layer (exactly-once-
  effect, like the lifecycle messages the events describe, and
  fire-and-forget for the producer: a flush never blocks task
  progress);
- the controller aggregates the merged stream, queryable via
  ``ray_tpu_torch.util.state.list_task_events`` / ``summarize_task_latency``,
  the dashboard (``/api/v0/events``, ``/timeline``), and the
  ``tools/timeline.py`` Perfetto exporter (:func:`build_chrome_trace`).

Event taxonomy (the ``ev`` field):

=================  =====================================================
``SUBMITTED``      owner submitted the task (driver or parent task)
``LEASED``         controller opened/assigned a worker lease for it
``DISPATCHED``     dispatch message sent toward the executing worker
``RUNNING``        worker began executing the task body
``YIELDED``        streaming generator stored+reported item ``index``
                   (a replayed prefix shows the same index from a new
                   pid — that IS the lineage replay, visually)
``FINISHED``       task body returned; ``FAILED`` carries ``error``
``RETRANSMIT``     reliable layer re-sent an unacked message (``type``,
                   ``attempt``)
``DUP_DROPPED``    receiver deduped a retransmit duplicate
``ACK_RTT``        an ack landed for a message that needed retransmits
                   (``rtt_s`` = send-to-ack, attempts included)
``CREDIT_STALL``   streaming producer blocked on the backpressure
                   window for ``seconds``
``DELIVERY_FAILED``reliable layer gave up on a message (typed error)
``STAGE_TICK``     MPMD pipeline stage interval: ``phase`` forward/
                   backward/opt/idle with ``stage``/``mb``/``dur_s``
                   and ``vs`` (virtual-stage chunk index) — rendered
                   as duration slices, so the Perfetto timeline IS
                   the pipeline-bubble visualization with per-chunk
                   forward/backward/optimizer occupancy per track
``SLICE_UP``       a TPU slice fully joined: every host VM registered
                   (``slice``/``type``/``hosts``)
``SLICE_DRAIN``    slice began draining (maintenance notice, idle
                   scale-down, or host death — ``reason``); no new
                   leases land on its hosts from this instant
``SLICE_DOWN``     slice released back to the provider; carries
                   ``dur_s`` = notice-to-release drain time, so the
                   drain window renders as a duration slice on
                   ``/timeline`` (the preemption postmortem)
``ELASTIC_NOTICE`` elastic trainer consumed a drain notice
                   (``slice``/``reason``) — recovery begins here
``ELASTIC_SNAPSHOT`` in-memory state snapshot for recovery completed;
                   ``dur_s`` = gather wall, ``live`` whether the state
                   was streamed from the running program (0 steps
                   lost) or fell back to the last periodic snapshot
``ELASTIC_RELOWER`` the plan was re-lowered onto the surviving
                   capacity (``from_plan``/``to_plan``, ``dur_s`` =
                   teardown + rebuild + reload wall)
``ELASTIC_RESUME`` training resumed; ``dur_s`` = the full
                   notice/failure-to-resume recovery window (rendered
                   as a duration slice — the recovery postmortem) and
                   ``steps_lost`` = re-executed steps
``ARBITER_PREEMPT`` the slice arbiter drained a training slice for the
                   serve fleet (``slice``/``reason``; ``dur_s`` = how
                   long serve pressure was sustained before the
                   arbiter acted — renders as the pressure window)
``ARBITER_RETURN`` serve pressure ebbed past hysteresis and the
                   arbiter returned capacity to training
                   (``reason``; ``dur_s`` = the whole borrow window,
                   preempt-to-return — the colocation postmortem)
``ARBITER_REJECT`` SLO-aware admission shed a request before it could
                   wedge a replica queue (``tenant``/``priority``/
                   ``reason``)
``RLHF_SYNC``      an in-flight weight refresh landed in a serving
                   engine between decode steps (``version``/
                   ``swap_s``/``active_slots`` — the MindSpeed-RL
                   no-drain swap; ``active_slots > 0`` proves decode
                   kept running through the refresh)
``RLHF_ROLLOUT``   a rollout round closed (``round``/``trajectories``/
                   ``tokens``/``policy_versions`` — which policies
                   generated this round's trajectories, the staleness
                   record PPO importance weights are computed against)
``KV_SHIP``        disagg prefill replica shipped a request's finished
                   KV blocks toward a decode replica (``blocks``/
                   ``bytes``/``wire`` — the hand-off's wire cost)
``KV_ADOPT``       decode replica adopted shipped KV blocks into its
                   pool + radix trie (``blocks``/``reused``/``dur_s``
                   — scatter + trie-insert wall before the first tick)
``PREFIX_MIGRATE`` warm radix-trie blocks moved off a draining replica
                   onto a survivor (``blocks``/``chains``/``dir``
                   export|import — the downscale warm-cache rescue)
=================  =====================================================
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---- event names -----------------------------------------------------
SUBMITTED = "SUBMITTED"
LEASED = "LEASED"
DISPATCHED = "DISPATCHED"
RUNNING = "RUNNING"
YIELDED = "YIELDED"
FINISHED = "FINISHED"
FAILED = "FAILED"
RETRANSMIT = "RETRANSMIT"
DUP_DROPPED = "DUP_DROPPED"
ACK_RTT = "ACK_RTT"
CREDIT_STALL = "CREDIT_STALL"
DELIVERY_FAILED = "DELIVERY_FAILED"
STAGE_TICK = "STAGE_TICK"
SLICE_UP = "SLICE_UP"
SLICE_DRAIN = "SLICE_DRAIN"
SLICE_DOWN = "SLICE_DOWN"
ELASTIC_NOTICE = "ELASTIC_NOTICE"
ELASTIC_SNAPSHOT = "ELASTIC_SNAPSHOT"
ELASTIC_RELOWER = "ELASTIC_RELOWER"
ELASTIC_RESUME = "ELASTIC_RESUME"
ARBITER_PREEMPT = "ARBITER_PREEMPT"
ARBITER_RETURN = "ARBITER_RETURN"
ARBITER_REJECT = "ARBITER_REJECT"
RLHF_SYNC = "RLHF_SYNC"
RLHF_ROLLOUT = "RLHF_ROLLOUT"
KV_SHIP = "KV_SHIP"
KV_ADOPT = "KV_ADOPT"
PREFIX_MIGRATE = "PREFIX_MIGRATE"

#: lifecycle events a task timeline is built from (exporter slice pairs)
LIFECYCLE = (SUBMITTED, LEASED, DISPATCHED, RUNNING, YIELDED,
             FINISHED, FAILED)

# ---- trace context ---------------------------------------------------
# A trace context is ``(trace_id, span_id)``: hex strings, propagated
# on control messages as ``(trace_id, parent_span)`` (the receiving
# task's own span id is derived from its task id, so it never ships).

_tls = threading.local()


def current() -> Optional[Tuple[str, str]]:
    """This thread's active ``(trace_id, span_id)``, or None."""
    return getattr(_tls, "ctx", None)


def set_context(trace_id: Optional[str], span_id: Optional[str]):
    """Install a trace context on this thread; returns the previous
    context (pass it to :func:`restore`)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (trace_id, span_id) if trace_id else None
    return prev


def restore(prev) -> None:
    _tls.ctx = prev


def new_span_id() -> str:
    return os.urandom(8).hex()


def child_trace(task_id_hex: str) -> Tuple[str, Optional[str]]:
    """The ``(trace_id, parent_span)`` pair to stamp on a submission:
    inherits the submitting thread's trace (a task executing under a
    propagated context, or a ``tracing.span``), else the new task roots
    its own trace."""
    cur = current()
    if cur is not None:
        return (cur[0], cur[1])
    return (task_id_hex[:32], None)


def task_trace(task_id_hex: str, trace: Optional[tuple]
               ) -> Tuple[str, str, Optional[str]]:
    """Resolve a task's full ``(trace_id, span_id, parent_span)`` from
    its propagated ``TaskSpec.trace`` (``(trace_id, parent)`` or
    None)."""
    span = task_id_hex[:16]
    if trace:
        return (trace[0], span, trace[1])
    return (task_id_hex[:32], span, None)


# ---- the recorder ----------------------------------------------------
class FlightRecorder:
    """Per-process bounded event ring. ``record()`` is the hot-path
    entry: one small dict + one deque append under a short lock;
    overflow drops the OLDEST event (counted). ``send`` ships drained
    batches (fire-and-forget — the runtime's flusher queue is
    non-blocking, and the wire message rides the reliable layer for
    exactly-once-effect at the controller)."""

    #: flush as soon as this many events are buffered (latency bound
    #: comes from the callers' periodic maybe_flush)
    WATERMARK = 256

    def __init__(self, proc: str, capacity: int = 4096,
                 send: Optional[Callable[[List[dict]], None]] = None,
                 interval_s: float = 1.0, enabled: bool = True):
        self.proc = proc
        self.pid = os.getpid()
        self.enabled = enabled
        self._send = send
        self._interval = interval_s
        self._cap = max(16, int(capacity))
        self._lock = threading.Lock()
        self._buf: "collections.deque[dict]" = collections.deque()
        self.dropped = 0
        self._last_flush = time.monotonic()
        self._dropped_metric = None

    # ------------------------------------------------------------ write
    def record(self, ev: str, task: Optional[Any] = None,
               trace: Optional[str] = None, span: Optional[str] = None,
               parent: Optional[str] = None, **data) -> None:
        if not self.enabled:
            return
        e: Dict[str, Any] = {"ev": ev, "ts": time.time(),
                             "proc": self.proc, "pid": self.pid}
        if task is not None:
            e["task"] = task.hex() if isinstance(task, bytes) else task
        if trace is not None:
            e["trace"] = trace
        if span is not None:
            e["span"] = span
        if parent is not None:
            e["parent"] = parent
        if data:
            e.update(data)
        flush_now = False
        with self._lock:
            self._buf.append(e)
            if len(self._buf) > self._cap:
                self._buf.popleft()
                self.dropped += 1
                self._count_drop_locked()
            flush_now = self._send is not None and \
                len(self._buf) >= self.WATERMARK
        if flush_now:
            self.flush()

    def record_task(self, ev: str, task_id_hex: str,
                    spec_trace: Optional[tuple], **data) -> None:
        """Record a lifecycle event with the trace triple resolved from
        a propagated ``TaskSpec.trace``."""
        t, s, p = task_trace(task_id_hex, spec_trace)
        self.record(ev, task=task_id_hex, trace=t, span=s, parent=p,
                    **data)

    def _count_drop_locked(self) -> None:
        m = self._dropped_metric
        if m is None:
            try:
                from ray_tpu_torch.core.metric_defs import runtime_metrics
                m = self._dropped_metric = \
                    runtime_metrics().events_dropped.bound()
            except Exception:
                return
        try:
            m.inc()
        except Exception:
            pass

    # ------------------------------------------------------------ drain
    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def drain(self) -> List[dict]:
        """Take every buffered event WITHOUT sending (controller local
        ingest, tests, shutdown dumps)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            self._last_flush = time.monotonic()
        return out

    def flush(self) -> None:
        """Ship every buffered event through ``send`` now. Never raises
        and never blocks on the network: the send hook enqueues into
        the process's async flusher."""
        if self._send is None:
            return
        evs = self.drain()
        if not evs:
            return
        try:
            self._send(evs)
        except Exception:
            # boot/shutdown window: the transport isn't up — the events
            # are observability, losing a batch must not hurt the task
            pass

    def maybe_flush(self, now: Optional[float] = None) -> None:
        """Time-based flush (call from any periodic loop; cheap no-op
        inside the interval)."""
        if self._send is None or not self._buf:
            return
        if (now or time.monotonic()) - self._last_flush >= self._interval:
            self.flush()


def make_recorder(proc: str, config, send=None) -> FlightRecorder:
    """Build a process's recorder from config knobs."""
    return FlightRecorder(
        proc,
        capacity=getattr(config, "task_events_ring_size", 4096),
        send=send,
        interval_s=getattr(config, "task_events_report_interval_ms",
                           1000) / 1000.0,
        enabled=getattr(config, "enable_task_events", True))


# ---- Perfetto / Chrome-trace export ----------------------------------
def _flow_id(span: str) -> int:
    try:
        return int(span[:15] or "0", 16) or 1
    except ValueError:
        return 1


def build_chrome_trace(events: List[dict],
                       counters: Optional[List[dict]] = None,
                       requests: Optional[List[dict]] = None) -> dict:
    """Render merged flight-recorder events as Chrome-trace/Perfetto
    JSON: one track (pid) per recording process, ``X`` slices for each
    RUNNING→FINISHED/FAILED execution attempt, instants for the other
    events, and flow arrows (``s``/``f`` pairs keyed by the task's span
    id) from each SUBMITTED site to every execution of that task — so
    a trace id can be followed visually across processes, replays
    included.

    ``counters`` (optional) are pre-built ``"ph": "C"`` counter events
    from the fleet metrics plane
    (``metrics_plane.MetricsPlane.chrome_counters``): each carries a
    ``proc`` key naming its origin process and is re-homed onto that
    process's track, so tokens/s / queue-depth / occupancy curves
    render alongside the spans they explain.

    ``requests`` (optional) are request-trace waterfalls
    (``RequestTraceStore.waterfall`` shape): each renders as an async
    track of ``b``/``e`` pairs keyed by its request_id — one lane per
    request on a dedicated "requests" process — with a flow arrow from
    the waterfall into the producing engine process's slices (the
    ``procs`` map shipped with each span batch names the anchor track),
    so a slow request can be followed from its QUEUED lane straight
    into the engine/stage ticks that explain it."""
    procs: Dict[str, int] = {}
    trace_events: List[dict] = []

    def pid_for(proc: str) -> int:
        p = procs.get(proc)
        if p is None:
            p = procs[proc] = len(procs) + 1
            trace_events.append({
                "ph": "M", "name": "process_name", "pid": p, "tid": 0,
                "args": {"name": proc}})
        return p

    by_task: Dict[str, List[dict]] = {}
    for e in events:
        if not isinstance(e, dict) or "ev" not in e:
            continue
        pid_for(e.get("proc", "?"))
        t = e.get("task")
        if t is not None:
            by_task.setdefault(t, []).append(e)

    for task, evs in sorted(by_task.items()):
        evs.sort(key=lambda e: e.get("ts", 0.0))
        span = next((e["span"] for e in evs if e.get("span")),
                    task[:16])
        trace = next((e["trace"] for e in evs if e.get("trace")), None)
        fid = _flow_id(span)
        base_args = {"task_id": task, "trace_id": trace,
                     "span_id": span}
        name = next((e.get("name") for e in evs if e.get("name")),
                    None) or f"task:{task[:12]}"
        # RUNNING..FINISHED/FAILED slice pairs, per process (an attempt
        # that died unflushed leaves an open RUNNING — rendered as an
        # instant instead of a bogus slice)
        open_run: Dict[str, dict] = {}
        for e in evs:
            pid = pid_for(e.get("proc", "?"))
            ts_us = e.get("ts", 0.0) * 1e6
            ev = e["ev"]
            if ev == RUNNING:
                open_run[e.get("proc", "?")] = e
                continue
            if ev in (FINISHED, FAILED):
                start = open_run.pop(e.get("proc", "?"), None)
                if start is not None:
                    t0 = start.get("ts", 0.0) * 1e6
                    trace_events.append({
                        "name": name, "cat": "task", "ph": "X",
                        "ts": t0, "dur": max(1.0, ts_us - t0),
                        "pid": pid, "tid": 0,
                        "args": dict(base_args, outcome=ev,
                                     error=e.get("error"))})
                    # flow target: the submission arrow lands at the
                    # start of this execution slice
                    trace_events.append({
                        "name": "submit", "cat": "flow", "ph": "f",
                        "bp": "e", "id": fid, "ts": t0 + 1,
                        "pid": pid, "tid": 0})
                    continue
            if ev == SUBMITTED:
                # small slice so the flow arrow has a source anchor
                trace_events.append({
                    "name": f"submit {name}", "cat": "task", "ph": "X",
                    "ts": ts_us, "dur": 50.0, "pid": pid, "tid": 0,
                    "args": dict(base_args, parent=e.get("parent"))})
                trace_events.append({
                    "name": "submit", "cat": "flow", "ph": "s",
                    "id": fid, "ts": ts_us + 1, "pid": pid, "tid": 0})
                continue
            args = dict(base_args)
            args.update({k: v for k, v in e.items()
                         if k not in ("ev", "ts", "proc", "pid", "task",
                                      "trace", "span", "parent")})
            trace_events.append({
                "name": ev if ev != YIELDED
                else f"yield[{e.get('index')}]",
                "cat": "task_event", "ph": "i", "s": "t",
                "ts": ts_us, "pid": pid, "tid": 0, "args": args})
        for proc, start in open_run.items():
            trace_events.append({
                "name": f"{name} (unfinished)", "cat": "task_event",
                "ph": "i", "s": "t", "ts": start.get("ts", 0.0) * 1e6,
                "pid": pid_for(proc), "tid": 0, "args": base_args})

    # transport / untasked events land on their process track. Events
    # carrying a duration (STAGE_TICK forward/backward/idle intervals)
    # render as X slices ending at their record timestamp — laid side
    # by side per process they ARE the pipeline schedule, and the gaps
    # plus the phase="idle" slices are the measured bubbles.
    for e in events:
        if not isinstance(e, dict) or "ev" not in e:
            continue
        if e.get("task") is not None:
            continue
        args = {k: v for k, v in e.items()
                if k not in ("ev", "ts", "proc", "pid")}
        dur_s = e.get("dur_s")
        if isinstance(dur_s, (int, float)) and dur_s > 0:
            name = e["ev"]
            if e.get("phase"):
                name = f"{name}:{e['phase']}"
                if e.get("mb") is not None:
                    name += f"[{e['mb']}]"
                if e.get("vs") is not None:
                    # virtual-stage (chunk) index: separates the
                    # interleaved chunks' occupancy on one stage track
                    name += f"@c{e['vs']}"
            trace_events.append({
                "name": name, "cat": "stage", "ph": "X",
                "ts": (e.get("ts", 0.0) - dur_s) * 1e6,
                "dur": max(1.0, dur_s * 1e6),
                "pid": pid_for(e.get("proc", "?")), "tid": 0,
                "args": args})
            continue
        trace_events.append({
            "name": e["ev"], "cat": "transport", "ph": "i", "s": "t",
            "ts": e.get("ts", 0.0) * 1e6,
            "pid": pid_for(e.get("proc", "?")), "tid": 0,
            "args": args})

    for c in counters or ():
        if not isinstance(c, dict) or c.get("ph") != "C":
            continue
        e = dict(c)
        proc = e.pop("proc", None)
        if proc is not None:
            e["pid"] = pid_for(proc)
        trace_events.append(e)

    # request waterfalls: one async lane per request id on a shared
    # "requests" process track
    for w in requests or ():
        if not isinstance(w, dict) or not w.get("request_id"):
            continue
        rid = w["request_id"]
        spans = [s for s in (w.get("spans") or ())
                 if isinstance(s, dict)]
        if not spans:
            continue
        rpid = pid_for("requests")
        for s in spans:
            t0_us = s.get("t0", 0.0) * 1e6
            t1_us = max(s.get("t1", 0.0) * 1e6, t0_us + 1.0)
            args = dict(s.get("attrs") or {}, request_id=rid)
            phase = s.get("phase", "?")
            trace_events.append({
                "name": phase, "cat": "request", "ph": "b",
                "id": rid, "ts": t0_us, "pid": rpid, "tid": 0,
                "args": args})
            trace_events.append({
                "name": phase, "cat": "request", "ph": "e",
                "id": rid, "ts": t1_us, "pid": rpid, "tid": 0})
        # flow arrow into the engine process's slices: source at the
        # waterfall's first engine-side span, target on the engine
        # track at the same instant (lands on whatever ENGINE_STATS /
        # stage-tick slice is active there)
        engine_proc = (w.get("procs") or {}).get("engine")
        anchor = next((s for s in spans
                       if s.get("phase") in ("ADMITTED", "PREFILL",
                                             "DECODE", "FIRST_TOKEN")),
                      None)
        if engine_proc and anchor is not None:
            fid = _flow_id(rid.rpartition("-")[2])
            ts_us = anchor.get("t0", 0.0) * 1e6
            trace_events.append({
                "name": "request", "cat": "flow", "ph": "s",
                "id": fid, "ts": ts_us + 1, "pid": rpid, "tid": 0})
            trace_events.append({
                "name": "request", "cat": "flow", "ph": "f",
                "bp": "e", "id": fid, "ts": ts_us + 2,
                "pid": pid_for(engine_proc), "tid": 0})

    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"source": "ray_tpu_torch flight recorder",
                          "processes": {v: k for k, v in procs.items()}}}
