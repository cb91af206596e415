"""Worker process: executes tasks and hosts actor instances.

Equivalent of the reference's worker loop (``python/ray/_private/workers/
default_worker.py`` → ``CCoreWorkerProcess.RunTaskExecutionLoop``
``_raylet.pyx:3267`` → ``task_execution_handler`` :2177). The main thread
executes normal tasks and in-order actor tasks (so SIGINT-based
``ray.cancel`` interrupts user code, like the reference); concurrent actors
use a thread pool, async actors an asyncio loop (reference:
``transport/actor_scheduling_queue.h``, ``fiber.h``).

Functions arrive by descriptor key and are fetched once from the
controller's function store then cached (reference:
``python/ray/_private/function_manager.py``).
"""

from __future__ import annotations

import asyncio
import copy
import logging
import os
import queue
import sys
import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.core import events as EV
from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core.global_state import set_global_worker
from ray_tpu_torch.core.ids import NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.runtime import Runtime, _ArgPlaceholder
from ray_tpu_torch.core.runtime import _DEFER as _RT_DEFER
from ray_tpu_torch.core.task_spec import TaskSpec
from ray_tpu_torch.exceptions import TaskCancelledError, TaskError

logger = logging.getLogger(__name__)


class _CallSequencer:
    """In-order admission for direct actor calls (reference: the
    ActorSchedulingQueue's seq_no ordering, actor_scheduling_queue.h).
    The submitter numbers calls per (caller, actor incarnation) at send
    time; this buffer releases them to the executor in that order,
    absorbing the reordering the reliable layer's retransmits can
    introduce (a dropped ACTOR_CALL is redelivered AFTER younger calls).

    Never a hang, always bounded delay: a gap that doesn't fill within
    ``hold_timeout`` is skipped (the missing call may genuinely never
    arrive — its sender can die mid-stream), every stream starts at
    seq 1 (submitters restart numbering per actor incarnation, so a
    reordered FIRST pair is still caught), and seqs below the stream
    cursor run immediately (controller-path retries of already-admitted
    calls). In a fault-free run every call arrives in order, so this is
    a dict lookup per call and nothing is ever held."""

    def __init__(self, deliver, hold_timeout: float = 10.0):
        self._deliver = deliver
        self._hold_timeout = hold_timeout
        self._lock = threading.Lock()
        self._next: Dict[bytes, int] = {}
        self._held: Dict[bytes, Dict[int, dict]] = {}
        self._timers: Dict[bytes, threading.Timer] = {}

    def admit(self, caller: bytes, seq: int, m: dict) -> None:
        with self._lock:
            nxt = self._next.get(caller, 1)
            if seq > nxt:
                held = self._held.setdefault(caller, {})
                held[seq] = m
                if len(held) > 512:
                    # pathological gap (or a stream the sender reset
                    # without us noticing): stop buffering, run in order
                    self._flush_locked(caller)
                elif caller not in self._timers:
                    t = threading.Timer(self._hold_timeout,
                                        self._on_timeout, args=(caller,))
                    t.daemon = True
                    self._timers[caller] = t
                    t.start()
                return
            if seq == nxt:
                nxt += 1
            # delivery happens under the lock: a concurrent timeout
            # flush must not interleave its batch with this one
            self._deliver(m)
            held = self._held.get(caller)
            while held and nxt in held:
                self._deliver(held.pop(nxt))
                nxt += 1
            self._next[caller] = nxt
            if not held:
                t = self._timers.pop(caller, None)
                if t is not None:
                    t.cancel()

    def _on_timeout(self, caller: bytes) -> None:
        with self._lock:
            self._timers.pop(caller, None)
            self._flush_locked(caller)

    def _flush_locked(self, caller: bytes) -> None:
        held = self._held.get(caller)
        if not held:
            return
        # a skipped gap is legal (bounded-delay ordering, never a hang)
        # but worth a line: at sane drop rates it means the missing
        # call's sender died mid-stream
        logger.warning(
            "actor-call stream from %s: predecessor seq %d never "
            "arrived within the reorder wait; running %d held calls",
            caller.hex()[:8], self._next.get(caller, 1), len(held))
        for seq in sorted(held):
            self._deliver(held[seq])
        self._next[caller] = max(self._next.get(caller, 1),
                                 max(held) + 1)
        held.clear()
        t = self._timers.pop(caller, None)
        if t is not None:
            t.cancel()


class WorkerExecutor:
    def __init__(self, runtime: Runtime):
        self.runtime = runtime
        self._queue: "queue.Queue[dict]" = queue.Queue()
        self._functions: Dict[str, Any] = {}
        self.actor_instance = None
        self.actor_spec: Optional[TaskSpec] = None
        self._thread_pool = None
        self._async_loop: Optional[asyncio.AbstractEventLoop] = None
        self._async_sema: Optional[asyncio.Semaphore] = None
        self._stop = False
        #: cancelled task ids -> expiry timestamp (math.inf once matched to
        #: a queued/running task; finite for cancels that matched nothing,
        #: which are kept briefly to cover the dequeue-to-mark window and
        #: then dropped so the map stays bounded)
        self._cancelled: Dict[bytes, float] = {}
        #: (caller identity, template id) -> cached actor-call TaskSpec
        #: template (see the compact-call path in _on_dispatch)
        self._tmpl_cache: "OrderedDict[tuple, TaskSpec]" = OrderedDict()
        #: task id executing on the MAIN thread only — pool/asyncio actor
        #: threads never publish here (a SIGINT raised off the running
        #: thread would corrupt unrelated serial state)
        self._current_tid: Optional[bytes] = None
        self._main_ident = threading.get_ident()
        #: learned wire bytes of the canonical ((), {}) args blob —
        #: lets _resolve_args skip deserializing no-arg fan-out calls
        self._empty_args_blob: Optional[bytes] = None
        #: streaming backpressure: task_id -> cumulative items the
        #: consumer reported consumed (STREAM_CREDIT); producers block
        #: on the condition when produced - consumed hits the window
        self._stream_cond = threading.Condition()
        self._stream_consumed: Dict[bytes, int] = {}
        runtime.stream_credit_handler = self._on_stream_credit
        self._rm = None  # cached runtime metrics handle
        self._stall_metric = None  # cached credit-stall counter handle
        self._block_depth = 0  # main thread blocked in ray.get inside task
        #: serializes the pump thread's dispatch-vs-blocked decision against
        #: on_block's queue drain (without it a dispatch passing the depth
        #: check could land in the queue after the drain and wedge behind
        #: the blocked serial thread)
        self._block_lock = threading.Lock()
        #: per-caller in-order admission for direct actor calls (the
        #: reliable layer redelivers drops out of order; see
        #: _CallSequencer)
        self._sequencer = _CallSequencer(
            self._admit_actor,
            hold_timeout=getattr(runtime.config,
                                 "actor_reorder_wait_s", 10.0))
        self.runtime.set_dispatch_handler(self._on_dispatch)
        self.runtime.block_notifier = self
        self.runtime.busy_probe = \
            lambda: self._current_tid is not None or not self._queue.empty()
        self._install_cancel_handler()

    def _install_cancel_handler(self) -> None:
        """SIGINT delivery is asynchronous: by the time the signal lands the
        cancelled task may have finished and a pipelined neighbour started.
        A targeted handler only raises when the interrupted task really is
        the cancelled one; stray/late signals are ignored instead of
        killing the worker (reference semantics: ray.cancel interrupts the
        task, never the worker process)."""
        import signal

        def handler(signum, frame):
            tid = self._current_tid
            if tid is not None and tid in self._cancelled:
                raise TaskCancelledError(TaskID(tid))

        try:
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not on the main thread (driver-embedded executor)

    # ------------------------------------------- blocked-worker protocol
    def on_block(self) -> bool:
        """The serial executor thread is about to wait on a remote result
        (reference: NotifyDirectCallTaskBlocked). Hand unstarted pipeline
        tasks back to the controller so they run elsewhere, and let the
        controller release this lease's cpu while we wait. Only the serial
        thread stalls its queue; concurrent/async actor threads blocking
        don't (their peers keep executing), so they skip the protocol."""
        if threading.get_ident() != self._main_ident:
            return False
        with self._block_lock:
            self._block_depth += 1
            if self._block_depth > 1:
                return True
            # NOTIFY_BLOCKED must precede the handback (FIFO): the
            # controller marks the lease blocked first, so the requeued
            # tasks cannot be pipelined straight back onto this worker
            self.runtime._send(P.NOTIFY_BLOCKED,
                               {"task_id": self._current_tid})
            if self.actor_instance is None:
                handback = []
                while True:
                    try:
                        m = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    spec = m.get("spec")
                    if spec is not None and not spec.is_actor_task \
                            and not spec.is_actor_creation:
                        handback.append(spec)
                    else:
                        self._queue.put(m)
                if handback:
                    self.runtime._send(P.TASK_HANDBACK, {"specs": handback})
        return True

    def on_unblock(self) -> None:
        with self._block_lock:
            self._block_depth -= 1
            if self._block_depth == 0:
                self.runtime._send(P.NOTIFY_UNBLOCKED, {})

    # dispatch arrives on the pump thread; queue for the main thread
    def _on_dispatch(self, m: dict) -> None:
        if m.get("cancel_queued"):
            self._on_cancel(m)
            return
        tmpl = m.get("tmpl")
        if tmpl is not None:
            # Compact actor calls (reference: the per-call task spec is
            # mostly static — the submitter ships it once per method and
            # subsequent calls carry only the dynamic fields; FIFO on
            # the peer channel guarantees the template precedes its
            # compact calls). Saves ~100us of spec pickling per call on
            # each side of the wire.
            key = (m.get("caller") or b"", tmpl)
            if "spec" in m:
                self._tmpl_cache[key] = m["spec"]
                while len(self._tmpl_cache) > 4096:
                    self._tmpl_cache.popitem(last=False)
            else:
                base = self._tmpl_cache.get(key)
                if base is None:
                    # evicted template or lost registration: ask the
                    # caller to resend this call with its full spec —
                    # silently dropping it would hang the caller's get
                    caller = m.get("caller") or b""
                    logger.warning(
                        "compact actor call without template (caller %s "
                        "tmpl %s): requesting resend", caller.hex()[:8],
                        tmpl)
                    if caller:
                        self.runtime._send_direct(
                            caller, P.TMPL_MISS,
                            {"task_id": m.get("task_id"), "tmpl": tmpl})
                    return
                self._tmpl_cache.move_to_end(key)
                spec = copy.copy(base)
                spec.task_id = TaskID(m["task_id"])
                spec.args_blob = m.get("args_blob", b"")
                spec.arg_refs = m.get("arg_refs") or []
                spec.arg_metas = m.get("arg_metas")
                spec.sequence_number = m.get("seq", -1)
                spec.trace = m.get("trace")
                m = dict(m, spec=spec)
        spec: TaskSpec = m["spec"]
        if not spec.is_actor_task and not spec.is_actor_creation:
            # a dispatch racing our NOTIFY_BLOCKED would wedge behind the
            # blocked serial thread — bounce it straight back (the lock
            # makes bounce-vs-drain atomic against on_block)
            with self._block_lock:
                if self._block_depth > 0:
                    # blocked hint: heals the controller's lease state if
                    # its NOTIFY_BLOCKED bookkeeping missed this worker
                    # (otherwise refill ping-pongs dispatches here forever)
                    self.runtime._send(P.TASK_HANDBACK,
                                       {"specs": [spec], "blocked": True})
                    return
                self._queue.put(m)
            return
        if spec.is_actor_task and spec.sequence_number > 0 \
                and spec.owner is not None:
            # per-caller in-order admission: retransmitted calls can
            # arrive after younger ones; the sequencer restores
            # submission order before execution
            self._sequencer.admit(spec.owner.binary(),
                                  spec.sequence_number, m)
            return
        self._admit_actor(m)

    def _admit_actor(self, m: dict) -> None:
        """Queue one actor creation/call for execution (post-ordering)."""
        spec: TaskSpec = m["spec"]
        if self.actor_instance is not None and spec.is_actor_task and (
                self.actor_spec.max_concurrency > 1 or self.actor_spec.is_async_actor):
            # concurrent/async actors bypass the serial queue
            if self.actor_spec.is_async_actor:
                asyncio.run_coroutine_threadsafe(
                    self._execute_async(m), self._async_loop)
            else:
                self._thread_pool.submit(self._execute, m)
        else:
            self._queue.put(m)

    def _on_cancel(self, m: dict) -> None:
        import math
        now = time.time()
        # purge expired unmatched cancels so the map stays bounded
        for k in [k for k, exp in self._cancelled.items() if exp < now]:
            self._cancelled.pop(k, None)
        tid = m["task_id"]
        # mark first so a task popped concurrently sees the flag at the
        # top of _execute, then decide how to deliver the cancel
        self._cancelled[tid] = math.inf
        if self._current_tid == tid:
            # interrupt user code on the main thread (reference:
            # SIGINT-based ray.cancel of a running task); the targeted
            # handler ignores the signal if the task finishes first.
            # Running concurrent/async actor tasks never publish
            # _current_tid — like the reference, they are not
            # interruptible once started.
            import signal
            try:
                os.kill(os.getpid(), signal.SIGINT)
            except Exception:
                pass
            return
        with self._queue.mutex:
            queued = any(item.get("spec") is not None
                         and item["spec"].task_id.binary() == tid
                         for item in self._queue.queue)
        if not queued and self._current_tid != tid:
            # probably already completed (dispatch and cancel ride the same
            # FIFO channel) — but the task may sit in the window between
            # run_loop's dequeue and _execute publishing _current_tid, so
            # keep the marker briefly instead of dropping it outright
            self._cancelled[tid] = now + 5.0

    def run_loop(self) -> None:
        ran_since_gc = False
        while not self._stop:
            try:
                m = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self.runtime._stopped.is_set():
                    break
                # idle: ship any buffered flight-recorder events (e.g.
                # retransmit events from the reliable layer's thread)
                # and the periodic fleet metric snapshot
                self.runtime.recorder.maybe_flush()
                self.runtime.metrics_reporter.maybe_report()
                if ran_since_gc:
                    # idle collection: zero-copy arg values that ended up
                    # in reference cycles hold reader leases on their shm
                    # extents (freed extents stay zombie until released);
                    # an idle worker must not pin them until its next
                    # allocation burst happens to trigger gen-2 GC
                    import gc
                    gc.collect()
                    ran_since_gc = False
                continue
            ran_since_gc = True
            try:
                self._execute(m)
            except (KeyboardInterrupt, TaskCancelledError):
                # backstop for a cancel signal landing in the gap before
                # _execute's try block: report the cancel instead of
                # letting the interrupt kill the worker / drop the task
                logger.warning("cancel interrupt outside task body")
                spec = m.get("spec")
                if spec is not None:
                    err = P.dumps(TaskCancelledError(spec.task_id))
                    self.runtime._send(P.TASK_DONE, {
                        "task_id": spec.task_id.binary(),
                        "trace": spec.trace,
                        "results": [{"object_id": oid.binary()}
                                    for oid in spec.return_ids()],
                        "error": err, "retriable": False,
                        "owner": spec.owner.binary() if spec.owner else None,
                        "owner_notified": False,
                        "is_actor_task": spec.is_actor_task,
                    })

    # --------------------------------------------------------- execution
    def _load_function(self, key: str):
        fn = self._functions.get(key)
        if fn is None:
            blob = self.runtime.fetch_function(key)
            if blob is None:
                raise RuntimeError(f"function {key} not found in function store")
            fn = cloudpickle.loads(blob)
            self._functions[key] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec, inline_args: Dict[bytes, bytes],
                      arg_errors: Dict[bytes, bytes]):
        # seed inline metas so get() short-circuits
        for b, blob in inline_args.items():
            self.runtime.seed_meta(b, {"object_id": b, "inline": blob})
        for b, err in arg_errors.items():
            raise P.loads(err)
        dep_values = []
        for _, oid in spec.arg_refs:
            b = oid.binary()
            meta = {"object_id": b, "inline": inline_args.get(b)}
            if inline_args.get(b) is not None:
                value = self.runtime._materialize(oid, meta)
            else:
                from ray_tpu_torch.core.object_ref import ObjectRef
                value = self.runtime._get_one(
                    ObjectRef(oid, _register=False),
                    self.runtime.config.rpc_timeout_s * 4)
            dep_values.append(value)
        args, kwargs = (), {}
        if spec.args_blob:
            # no-arg fan-out calls all ship the owner's one cached empty
            # blob (runtime.serialize_args) — skip the parse entirely
            blob = spec.args_blob
            if blob == self._empty_args_blob:
                return (), {}
            (args, kwargs), _ = self.runtime.serialization.deserialize_from_view(
                memoryview(blob))
            if not args and not kwargs and not spec.arg_refs:
                self._empty_args_blob = blob
        args = tuple(dep_values[a.index] if isinstance(a, _ArgPlaceholder) else a
                     for a in args)
        kwargs = {k: dep_values[v.index] if isinstance(v, _ArgPlaceholder) else v
                  for k, v in kwargs.items()}
        return args, kwargs

    def _execute(self, m: dict) -> None:
        spec: TaskSpec = m["spec"]
        tid_b = spec.task_id.binary()
        self.runtime.current_task_id = spec.task_id
        on_main = threading.get_ident() == self._main_ident
        if on_main:
            self._current_tid = tid_b
        # install the propagated trace context on THIS thread: tasks
        # this task submits become its causal children, and every
        # lifecycle event below carries the same trace id
        tid_hex = spec.task_id.hex()
        trace_id, span_id, parent_span = EV.task_trace(
            tid_hex, getattr(spec, "trace", None))
        trace_tok = EV.set_context(trace_id, span_id)
        rec = self.runtime.recorder
        rec.record(EV.RUNNING, task=tid_hex, trace=trace_id,
                   span=span_id, parent=parent_span,
                   name=spec.name or spec.function.qualname)
        start = time.time()
        error_blob = None
        retriable = True
        results = []
        values: Optional[list] = None
        stream_metas: Optional[list] = None
        restore_env = None
        try:
            if tid_b in self._cancelled:
                self._cancelled.pop(tid_b, None)
                raise TaskCancelledError(spec.task_id)
            if spec.runtime_env and not spec.is_actor_task \
                    and not spec.is_actor_creation:
                # normal tasks mount their env for THIS task only: pool
                # workers are shared, so env/cwd/sys.path are restored
                # after execution (reference: env-keyed worker pools)
                restore_env = self._apply_runtime_env(spec.runtime_env)
            args, kwargs = self._resolve_args(
                spec, m.get("inline_args") or {}, m.get("arg_errors") or {})
            from ray_tpu_torch.util.tracing import task_execution_span
            with task_execution_span(
                    spec.name or spec.function.qualname,
                    getattr(spec, "trace", None)):
                if spec.is_actor_creation:
                    values = [self._create_actor_instance(
                        spec, args, kwargs)]
                elif spec.is_streaming:
                    # streaming generator task: items are stored and
                    # reported eagerly inside; `values` stays empty and
                    # the trimmed item metas become the TASK_DONE results
                    stream_metas = self._run_streaming(spec, args, kwargs)
                    values = []
                elif spec.is_actor_task:
                    values = self._run_actor_method(spec, args, kwargs)
                else:
                    fn = self._load_function(spec.function.key())
                    out = fn(*args, **kwargs)
                    values = list(out) if spec.num_returns > 1 else [out]
            if not spec.is_streaming and len(values) != spec.num_returns:
                raise ValueError(
                    f"task returned {len(values)} values, expected "
                    f"{spec.num_returns}")
        except KeyboardInterrupt:
            error_blob = P.dumps(TaskCancelledError(spec.task_id))
            retriable = False
        except TaskCancelledError as e:
            error_blob = P.dumps(e)
            retriable = False
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, TaskError):
                err = e
            else:
                err = TaskError.from_exception(
                    spec.name or spec.function.qualname, e)
            error_blob = P.dumps(err)
            retriable = bool(spec.retry_exceptions)
            logger.warning("task %s failed:\n%s", spec.name,
                           err.traceback_str if hasattr(err, "traceback_str") else err)
        # user code is done: step out of the cancel window NOW so a late
        # SIGINT cannot interrupt result storage / the TASK_DONE send
        if on_main:
            self._current_tid = None
        self._cancelled.pop(tid_b, None)
        EV.restore(trace_tok)
        if restore_env is not None:
            try:
                restore_env()
            except Exception:
                logger.exception("runtime_env restore failed")
        if error_blob is None:
            for i, value in enumerate(values):
                oid = ObjectID.for_task_return(spec.task_id, i + 1)
                try:
                    meta = self.runtime._store_value(oid, value, notify=False)
                except BaseException as e:  # noqa: BLE001
                    error_blob = P.dumps(TaskError.from_exception(
                        spec.name or spec.function.qualname, e))
                    results = []
                    break
                results.append(meta)
            if stream_metas is not None:
                # streamed items were stored and owner-reported in-band;
                # TASK_DONE ships the trimmed metas so the controller
                # records shm locations + lineage (inline items stay
                # owner-local — the owner got their bytes via
                # STREAM_ITEM, the controller only needs existence)
                results = stream_metas
        if error_blob is not None:
            results = [{"object_id": oid.binary()}
                       for oid in spec.return_ids()]
        # Result meta goes DIRECT to the owner (reference: task replies go
        # straight to the submitting core worker, not through the GCS);
        # TASK_DONE to the controller keeps the object directory / task
        # table / lease accounting consistent, off the latency path.
        # Retriable errors are NOT final — the controller owns the retry
        # decision, so those defer to its TASK_RESULT forward.
        owner_b = spec.owner.binary() if spec.owner else None
        may_retry = (error_blob is not None and retriable
                     and spec.max_retries != 0)
        direct_ok = owner_b is not None and not may_retry
        result_msg = None
        driver_leased = bool(m.get("driver_leased"))
        if direct_ok:
            # shallow-copy the metas: TASK_DONE carries the same list,
            # and a same-process owner stores these dicts directly.
            # Streaming tasks ship NO result metas here: the owner's
            # authoritative per-item metas arrived via STREAM_ITEM, and
            # the trimmed TASK_DONE copies must not overwrite them.
            result_msg = (owner_b, P.TASK_RESULT, {
                "task_id": tid_b,
                "trace": spec.trace,
                "results": [] if spec.is_streaming else
                [dict(r, error=error_blob) for r in results],
                "error": error_blob,
                "actor_id": spec.actor_id.binary() if spec.is_actor_task
                else None,
                # controller-path dispatch: the controller records these
                # results in its directory, so the owner must promote
                # owner-local returns to tracked (covers retry re-routes
                # of originally-direct tasks too)
                "via_controller": not driver_leased
                and not spec.is_actor_task,
            })
        done_results = results
        if direct_ok and self.runtime._owner_local and error_blob is None \
                and (driver_leased or spec.is_actor_task):
            # (The direct RES push is reliably delivered — ack +
            # retransmit, core/reliable.py — so the trim is safe under
            # injected drops too; the owner's grace-then-probe fallback
            # now only covers worker death with the result unflushed.)
            # owner-local mode, direct dispatch (driver lease / actor
            # call): the owner (which just got TASK_RESULT) is the
            # authority for inline results — the controller neither
            # records nor needs their bytes. Shm results keep full
            # metas (the directory tracks extents). Controller-path
            # tasks are NOT trimmed: the controller records their
            # results and unparks dependents from them.
            done_results = [r if r.get("node_id") is not None
                            else {"object_id": r["object_id"],
                                  "size": r.get("size", 0)}
                            for r in results]
        done = {
            "task_id": tid_b,
            "trace": spec.trace,
            "results": done_results,
            "error": error_blob,
            "retriable": retriable,
            "owner": owner_b,
            "owner_notified": direct_ok,
            # flag only — re-shipping the whole spec (args blob included)
            # on every actor call would tax the hot path
            "is_actor_task": spec.is_actor_task,
        }
        if stream_metas is not None:
            done["streaming"] = True
            done["stream_count"] = len(stream_metas)
        if m.get("driver_leased"):
            # direct driver-leased dispatch: tell the controller to skip
            # worker/lease bookkeeping; retriable errors ship the spec so
            # the controller can re-route through the normal scheduler
            done["driver_leased"] = True
            if may_retry:
                done["spec"] = spec
        if may_retry and spec.is_actor_task:
            # direct actor calls have no controller-side PendingTask; ship
            # the spec so the controller can re-route the retry
            done["spec"] = spec
        # one queue handoff for both messages: each _out_q put can wake
        # the flusher thread (a futex round-trip per task adds up).
        # Direct-path completions (driver-leased / actor calls) defer
        # their TASK_DONE a few ms: the owner already has the result via
        # RES, the controller only records — batching the accounting
        # frees the shared core for the caller's latency path. Errors
        # stay immediate (the controller owns the retry decision).
        defer_done = error_blob is None and direct_ok \
            and (driver_leased or spec.is_actor_task)
        done_tgt = _RT_DEFER if defer_done else None
        done_msg = (done_tgt, P.TASK_DONE, done)
        if result_msg is not None:
            self.runtime._send_many([result_msg, done_msg])
        else:
            self.runtime._send_many([done_msg])
        try:
            rm = self._rm
            if rm is None:
                from ray_tpu_torch.core.metric_defs import runtime_metrics
                base = runtime_metrics()
                rm = self._rm = (
                    base.tasks_finished.bound({"outcome": "ok"}),
                    base.tasks_finished.bound({"outcome": "error"}),
                    base.task_exec_seconds.bound())
            rm[1 if error_blob else 0].inc()
            rm[2].observe(time.time() - start)
        except Exception:
            pass
        self.runtime.record_span(
            spec.name or spec.function.qualname, start, time.time() - start,
            task_id=spec.task_id.hex())
        rec.record(EV.FAILED if error_blob is not None else EV.FINISHED,
                   task=tid_hex, trace=trace_id, span=span_id,
                   parent=parent_span,
                   name=spec.name or spec.function.qualname,
                   dur_s=round(time.time() - start, 6))
        rec.maybe_flush()
        self.runtime.current_task_id = self.runtime._driver_task_id

    async def _execute_async(self, m: dict) -> None:
        # None = the loop's default executor, which actor setup replaced
        # with a max_concurrency-sized pool (the asyncio default would
        # cap concurrency at min(32, cpus+4) and deadlock against user
        # run_in_executor work — see _create_actor_instance).
        async with self._async_sema:
            await asyncio.get_event_loop().run_in_executor(
                None, lambda: self._execute_async_inner(m))

    def _execute_async_inner(self, m: dict) -> None:
        # For async actors, coroutine methods run on the loop; delegate
        # through _execute with coroutine awaiting inside _run_actor_method.
        self._execute(m)

    # ------------------------------------------------------------- actors
    def _create_actor_instance(self, spec: TaskSpec, args, kwargs):
        cls = self._load_function(spec.function.key())
        if spec.runtime_env:
            self._apply_runtime_env(spec.runtime_env)
        self.actor_instance = cls(*args, **kwargs)
        self.actor_spec = spec
        self.runtime._current_actor_id = spec.actor_id
        if spec.max_concurrency > 1 and not spec.is_async_actor:
            from concurrent.futures import ThreadPoolExecutor
            self._thread_pool = ThreadPoolExecutor(spec.max_concurrency)
        if spec.is_async_actor:
            self._async_loop = asyncio.new_event_loop()
            # Dedicated executor installed as the loop's default.
            # asyncio's built-in default executor is min(32, cpus+4)
            # threads — on small hosts that silently caps actor
            # concurrency below max_concurrency, and DEADLOCKS when
            # user code shares the default executor: a streaming call
            # occupies one thread for its whole life, and the user
            # coroutine's own run_in_executor work queues behind
            # further calls that are waiting for those same threads.
            # Sized 2x + margin so every admitted call (semaphore caps
            # them at max_concurrency) can nest one run_in_executor of
            # its own without exhausting the pool.
            from concurrent.futures import ThreadPoolExecutor
            self._async_pool = ThreadPoolExecutor(
                2 * max(2, spec.max_concurrency) + 2,
                thread_name_prefix="actor-async-exec")
            self._async_loop.set_default_executor(self._async_pool)
            t = threading.Thread(target=self._async_loop.run_forever,
                                 name="actor-asyncio", daemon=True)
            t.start()
            fut = asyncio.run_coroutine_threadsafe(
                self._make_sema(spec.max_concurrency), self._async_loop)
            fut.result()
        return None

    async def _make_sema(self, n: int) -> None:
        self._async_sema = asyncio.Semaphore(max(1, n))

    def _run_actor_method(self, spec: TaskSpec, args, kwargs):
        if self.actor_instance is None:
            from ray_tpu_torch.exceptions import ActorDiedError
            raise ActorDiedError(spec.actor_id, "no instance in this worker")
        name = spec.function.qualname
        if name == "__ray_ready__":
            return [True]
        if name == "__ray_call__":
            # generic invoke: fn(actor_instance, *args, **kwargs)
            fn, rest = args[0], args[1:]
            out = fn(self.actor_instance, *rest, **kwargs)
            return list(out) if spec.num_returns > 1 else [out]
        if name == "__ray_terminate__":
            self._stop = True
            threading.Thread(target=self._delayed_exit, daemon=True).start()
            return [None]
        method = getattr(self.actor_instance, name)
        out = method(*args, **kwargs)
        if asyncio.iscoroutine(out):
            if self._async_loop is not None and \
                    threading.current_thread().name != "actor-asyncio":
                fut = asyncio.run_coroutine_threadsafe(out, self._async_loop)
                out = fut.result()
            else:
                out = asyncio.new_event_loop().run_until_complete(out)
        return list(out) if spec.num_returns > 1 else [out]

    # ------------------------------------------------ streaming generators
    def _on_stream_credit(self, m: dict) -> None:
        """Pump-thread: the consumer reported cumulative consumption —
        open the producer's backpressure window. Credits are monotonic;
        stale/reordered ones are ignored."""
        with self._stream_cond:
            tid = m.get("task_id")
            cur = self._stream_consumed.get(tid)
            if cur is not None and m.get("consumed", 0) > cur:
                self._stream_consumed[tid] = m["consumed"]
                self._stream_cond.notify_all()

    def _stream_wait_window(self, tid_b: bytes, produced: int,
                            window: int) -> None:
        """Block until the consumer's credit opens the window (produced
        - consumed < window). Interruptible: ray.cancel (SIGINT on the
        main thread, the cancel flag elsewhere) and executor shutdown
        break the wait — a producer must never outlive its consumer's
        interest.

        A credit wait is an open-ended remote wait, exactly like a
        ray.get inside a task: the blocked-worker protocol applies
        (NOTIFY_BLOCKED + pipeline handback), or a slow consumer would
        wedge every task queued behind this one on the serial thread
        and pin a cpu the cluster could use."""

        def open_locked() -> bool:
            return produced - self._stream_consumed.get(tid_b, 0) < window

        with self._stream_cond:
            if open_locked():
                return  # fast path: no protocol round-trip
        token = self.runtime._enter_blocked()
        stall_t0 = time.monotonic()
        try:
            with self._stream_cond:
                while not open_locked():
                    if tid_b in self._cancelled or self._stop or \
                            self.runtime._stopped.is_set():
                        raise TaskCancelledError(TaskID(tid_b))
                    self._stream_cond.wait(0.1)
        finally:
            self.runtime._exit_blocked(token)
            stalled = time.monotonic() - stall_t0
            # producer blocked on the backpressure window: the signal
            # Podracer-style overlap tuning needs (a persistently
            # stalled producer means the consumer is the bottleneck)
            try:
                rm = self._stall_metric
                if rm is None:
                    from ray_tpu_torch.core.metric_defs import runtime_metrics
                    rm = self._stall_metric = \
                        runtime_metrics().credit_stall_seconds.bound()
                if stalled > 0:
                    rm.inc(stalled)
            except Exception:
                pass
            self.runtime.recorder.record(
                EV.CREDIT_STALL, task=tid_b.hex(),
                seconds=round(stalled, 6), produced=produced)

    def _agen_iter(self, agen):
        """Bridge an async generator to a sync iterator: on an async
        actor, items are pulled through the actor's event loop (user
        code may await shared state there); elsewhere a private loop
        drives it. The finally runs on close() too (cancelled stream):
        the source's aclose() must fire promptly so its own finally
        blocks (e.g. the serve replica's ongoing-count decrement) run,
        instead of waiting for some distant GC."""
        if self._async_loop is not None:
            try:
                while True:
                    try:
                        fut = asyncio.run_coroutine_threadsafe(
                            agen.__anext__(), self._async_loop)
                        yield fut.result()
                    except StopAsyncIteration:
                        return
            finally:
                try:
                    asyncio.run_coroutine_threadsafe(
                        agen.aclose(), self._async_loop).result(5.0)
                except Exception:
                    pass
        else:
            loop = asyncio.new_event_loop()
            try:
                while True:
                    try:
                        yield loop.run_until_complete(agen.__anext__())
                    except StopAsyncIteration:
                        return
            finally:
                try:
                    loop.run_until_complete(agen.aclose())
                except Exception:
                    pass
                loop.close()

    def _make_stream_iterator(self, spec: TaskSpec, args, kwargs):
        """Invoke the task body and normalize its result to a sync
        iterator of yielded items."""
        import inspect
        if spec.is_actor_task:
            if self.actor_instance is None:
                from ray_tpu_torch.exceptions import ActorDiedError
                raise ActorDiedError(spec.actor_id,
                                     "no instance in this worker")
            method = getattr(self.actor_instance, spec.function.qualname)
            out = method(*args, **kwargs)
        else:
            fn = self._load_function(spec.function.key())
            out = fn(*args, **kwargs)
        if inspect.iscoroutine(out):
            # an async (non-generator) method returning a generator:
            # resolve it first. inspect, not asyncio: the asyncio
            # predicate also matches plain generators (legacy
            # generator-coroutines), which must stream as-is.
            if self._async_loop is not None and \
                    threading.current_thread().name != "actor-asyncio":
                out = asyncio.run_coroutine_threadsafe(
                    out, self._async_loop).result()
            else:
                out = asyncio.new_event_loop().run_until_complete(out)
        if inspect.isasyncgen(out):
            return self._agen_iter(out)
        if inspect.isgenerator(out) or hasattr(out, "__iter__"):
            return iter(out)
        raise TypeError(
            f"num_returns='streaming' requires "
            f"{spec.name or spec.function.qualname!r} to return a "
            f"generator, got {type(out).__name__}")

    def _run_streaming(self, spec: TaskSpec, args, kwargs) -> list:
        """Execute a generator task: eagerly store each yielded item as
        its own object and report it (STREAM_ITEM, reliable) the moment
        it exists; STREAM_EOF closes the stream (reference:
        ``ReportGeneratorItemReturns``, core_worker.cc). Consumer-paced:
        blocks at the backpressure window until credits arrive. Returns
        the trimmed item metas for TASK_DONE (controller records shm
        locations + lineage off them).

        Error semantics: a mid-stream exception is delivered AS the
        failing item (typed, ordered) followed by EOF — unless the task
        may retry (retry_exceptions + retries budgeted), in which case
        nothing terminal is emitted and the replay re-reports the
        stream from index 1 (the owner dedups)."""
        from ray_tpu_torch.core.ids import ObjectID as _OID
        rt = self.runtime
        tid_b = spec.task_id.binary()
        owner_b = spec.owner.binary() if spec.owner else None
        me = rt.worker_id.binary()
        window = spec.backpressure or getattr(
            rt.config, "generator_backpressure_num_objects", 64)
        with self._stream_cond:
            self._stream_consumed.setdefault(tid_b, 0)
        metas = []
        produced = 0
        it = None

        tid_hex = spec.task_id.hex()
        trace_id, span_id, parent_span = EV.task_trace(
            tid_hex, getattr(spec, "trace", None))

        def send_item(index: int, meta: dict,
                      nbytes: Optional[int] = None) -> None:
            rt.recorder.record(EV.YIELDED, task=tid_hex, trace=trace_id,
                               span=span_id, parent=parent_span,
                               index=index,
                               **({"nbytes": nbytes} if nbytes else {}))
            if owner_b:
                rt._send_direct(owner_b, P.STREAM_ITEM, {
                    "task_id": tid_b, "index": index, "meta": meta,
                    "worker": me, "trace": spec.trace})
            rt.recorder.maybe_flush()
            # long-lived generators (pipeline stages, data pipelines)
            # may never hit the idle loop: yield time is their metric
            # heartbeat
            rt.metrics_reporter.maybe_report()

        def send_eof(count: int) -> None:
            if owner_b:
                rt._send_direct(owner_b, P.STREAM_EOF, {
                    "task_id": tid_b, "count": count, "worker": me,
                    "trace": spec.trace})

        try:
            it = self._make_stream_iterator(spec, args, kwargs)
            while True:
                if window > 0:
                    self._stream_wait_window(tid_b, produced, window)
                if tid_b in self._cancelled:
                    raise TaskCancelledError(spec.task_id)
                try:
                    value = next(it)
                except StopIteration:
                    break
                # device-array fast path: fetch device->host NOW, on
                # the generator's thread, so the store+report path (and
                # any lock it takes) never blocks on an accelerator
                # transfer; the serializer then ships the host view
                # out-of-band instead of through the pickle stream
                from ray_tpu_torch.core.serialization import to_host
                value = to_host(value)
                produced += 1
                oid = _OID.for_task_return(spec.task_id, produced)
                meta = rt._store_value(oid, value, notify=True)
                metas.append(
                    meta if meta.get("node_id") is not None
                    else {"object_id": meta["object_id"],
                          "size": meta.get("size", 0)})
                send_item(produced, meta, meta.get("size"))
        except (KeyboardInterrupt, TaskCancelledError):
            # cancelled (usually by the consumer closing the stream):
            # EOF for any straggler consumer, then the normal cancel
            # reporting path
            send_eof(produced)
            raise
        except BaseException as e:  # noqa: BLE001
            if spec.retry_exceptions and spec.max_retries != 0:
                # a retry may replay the stream cleanly — emit nothing
                # terminal (the owner dedups the replayed prefix)
                raise
            # typed mid-stream exception delivered as the failing item
            produced += 1
            oid = _OID.for_task_return(spec.task_id, produced)
            err = e if isinstance(e, TaskError) else \
                TaskError.from_exception(
                    spec.name or spec.function.qualname, e)
            item_meta = {"object_id": oid.binary(), "error": P.dumps(err)}
            rt.seed_meta(oid.binary(), item_meta)
            send_item(produced, item_meta)
            send_eof(produced)
            raise err
        finally:
            with self._stream_cond:
                self._stream_consumed.pop(tid_b, None)
            # close the (possibly abandoned) generator NOW: its finally
            # blocks — and for async gens the bridged aclose() — must
            # not wait for GC (a cancelled serve stream would otherwise
            # leak the replica's ongoing-count until collection)
            if it is not None:
                try:
                    it.close()
                except Exception:
                    pass
        send_eof(produced)
        return metas

    @staticmethod
    def _apply_runtime_env(env: dict):
        """env_vars + cached working_dir/py_modules mounts (reference:
        the worker half of the runtime-env agent; pip/conda rejected at
        submission — hermetic image). Returns the restore callable
        (used for normal tasks; actors keep their env for life)."""
        from ray_tpu_torch.core.runtime_env import apply_runtime_env
        return apply_runtime_env(env)


def _orphan_watchdog(parent_pid: int,
                     node_pid: Optional[int] = None) -> None:
    """Exit when the spawning node manager's process dies (reference:
    workers poll raylet liveness and die with it — core_worker.cc
    CheckForRayletFailure). Workers start in their own session, so no
    SIGHUP arrives; without this they outlive dead clusters.

    Zygote-forked workers are NOT children of the node manager (the
    double fork reparents them to init), and worse, the getppid()
    captured at main() can be the short-lived intermediate fork parent
    — its exit then looked exactly like node-manager death and killed
    ~20% of workers in actor bursts. When the node manager's pid is
    known (RAY_TPU_TORCH_NODE_PID), poll THAT process directly."""
    while True:
        time.sleep(2.0)
        if node_pid is not None:
            try:
                os.kill(node_pid, 0)
                continue
            except ProcessLookupError:
                pass
            except PermissionError:
                continue
        elif os.getppid() == parent_pid:
            continue
        logging.getLogger(__name__).warning(
            "node manager process died; worker exiting")
        os._exit(1)


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    dump_after = os.environ.get("RAY_TPU_TORCH_WORKER_FAULTDUMP")
    if dump_after:
        # debugging aid: dump all thread stacks to the worker log every
        # N seconds (hang diagnosis; reference: `ray stack`)
        import faulthandler
        faulthandler.dump_traceback_later(
            float(dump_after), repeat=True)
    node_pid = os.environ.get("RAY_TPU_TORCH_NODE_PID")
    threading.Thread(target=_orphan_watchdog,
                     args=(os.getppid(),
                           int(node_pid) if node_pid else None),
                     daemon=True).start()
    # Honor an explicit platform override before any task can touch
    # CUDA: RAY_TPU_TORCH_PLATFORM=cpu keeps this worker off every card
    # (tests force CPU workers with it).
    if os.environ.get("RAY_TPU_TORCH_PLATFORM") == "cpu":
        from ray_tpu_torch.core.accelerators import hide_gpus
        hide_gpus()
    session_dir = os.environ["RAY_TPU_TORCH_SESSION_DIR"]
    node_id = NodeID.from_hex(os.environ["RAY_TPU_TORCH_NODE_ID"])
    worker_id = WorkerID.from_hex(os.environ["RAY_TPU_TORCH_WORKER_ID"])
    shm_session = os.environ["RAY_TPU_TORCH_SHM_SESSION"]
    if os.environ.get("RAY_TPU_TORCH_CHAOS_SEED"):
        # header line so a red chaos run maps worker logs to the seeded
        # decision stream that produced them
        logging.getLogger(__name__).warning(
            "chaos: worker %s under fault injection (seed=%s stream "
            "id=%s)", worker_id.hex()[:12],
            os.environ.get("RAY_TPU_TORCH_CHAOS_SEED"),
            os.environ.get("RAY_TPU_TORCH_CHAOS_ID", ""))
    boot_t0 = time.perf_counter()
    bootprof = os.environ.get("RAY_TPU_TORCH_WORKER_BOOTPROF")

    def mark(stage: str) -> None:
        if bootprof:
            print(f"BOOT {stage} {time.perf_counter() - boot_t0:.3f} "
                  f"cpu={time.process_time():.3f}", flush=True)

    runtime = Runtime("worker", session_dir, node_id, worker_id, shm_session)
    mark("runtime")
    set_global_worker(runtime)
    runtime.register()
    mark("registered")
    executor = WorkerExecutor(runtime)
    mark("executor")
    profile_out = os.environ.get("RAY_TPU_TORCH_PROFILE_WORKER")
    if profile_out:
        # drop a cProfile of the execution loop at exit (debugging aid:
        # per-task overhead hunting; reference: `ray stack`/py-spy fill
        # this role). SIGTERM becomes a clean loop stop so the stats
        # actually flush.
        import cProfile
        import signal as _sig
        _sig.signal(_sig.SIGTERM,
                    lambda *_: setattr(executor, "_stop", True))
        pr = cProfile.Profile()
        try:
            pr.runcall(executor.run_loop)
        finally:
            pr.dump_stats(f"{profile_out}.{os.getpid()}")
            runtime.shutdown()
        return
    try:
        executor.run_loop()
    finally:
        runtime.shutdown()


if __name__ == "__main__":
    main()
