"""Streaming generator tasks: the caller side of ``num_returns="streaming"``.

Equivalent of the reference's ``ObjectRefGenerator``
(``python/ray/_raylet.pyx`` ``ObjectRefGenerator`` / ``StreamingObjectRefGenerator``
backed by ``TaskManager::ObjectRefStream``, ``task_manager.h``): a worker
executing a generator (or async-generator) task eagerly stores each
yielded item as its own object — ``ObjectID.for_task_return(task_id, i)``
— and reports it with a ``STREAM_ITEM`` control message the moment it
exists; ``STREAM_EOF`` closes the stream. Both ride the reliable-delivery
layer (``core/reliable.py``), so item reports are exactly-once-effect and
the per-index bookkeeping here only has to absorb *reordering* (a
retransmitted item can land after younger ones) and *replay* (lineage
re-execution after a mid-stream worker death re-reports from index 1).

The owner-side :class:`StreamState` is the analog of the reference's
``ObjectRefStream``: it buffers minted item refs by index, hands them to
the consumer strictly in yield order, tracks EOF, and reports cumulative
consumption back to the producer (``STREAM_CREDIT``) so a fast producer
blocks at the backpressure window instead of flooding the object store
(reference: ``_generator_backpressure_num_objects``).

Reference counting is per item: every reported item registers one local
ref owned by the stream; ``__next__`` transfers that ref to the consumer,
so consumed items are freed independently of the stream and of each
other. ``close()`` (or GC of an abandoned generator) drops the buffered
refs and cancels the producer task, so early termination leaks neither
objects nor a running generator.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.memory_store import fresh_error
from ray_tpu_torch.core.object_ref import ObjectRef

if TYPE_CHECKING:  # pragma: no cover
    from ray_tpu_torch.core.runtime import Runtime


class StreamState:
    """Owner-side record of one in-flight streaming task (reference:
    ``TaskManager::ObjectRefStream``). Created BEFORE the task is
    submitted so the earliest ``STREAM_ITEM`` cannot race it."""

    def __init__(self, runtime: "Runtime", task_id_b: bytes):
        self.runtime = runtime
        self.task_id_b = task_id_b
        self.cond = threading.Condition()
        #: minted-but-unconsumed item refs, keyed by 1-based yield index
        self.items: Dict[int, ObjectRef] = {}
        #: next index to hand to the consumer (== 1 + items consumed)
        self.next_index = 1
        #: total item count, set by STREAM_EOF (error item included)
        self.eof_index: Optional[int] = None
        #: stream-level failure (actor died, delivery gave up, task
        #: failed terminally with retries exhausted) — raised at next()
        self.error: Optional[BaseException] = None
        #: identity of the latest reporting worker (credits go here;
        #: a lineage replay moves it to the replaying worker)
        self.producer: Optional[bytes] = None
        self.closed = False
        #: highest index ever reported (replay/reorder dedup)
        self.received_max = 0
        #: causal trace of the producing task (core/events.py):
        #: ``(trace_id, parent_span)`` — rides STREAM_CREDIT so every
        #: control hop of the stream carries the link
        self.trace: Optional[tuple] = None
        #: credit batching: cumulative credits are idempotent, so the
        #: consumer only reports every ``credit_batch`` items — EXCEPT
        #: when its buffer just drained (the producer may be blocked at
        #: the window; an unsent credit there would deadlock). Halves of
        #: small windows flush eagerly; 1 restores per-item credits.
        self.credit_batch = max(
            1, min(8, getattr(runtime.config,
                              "generator_backpressure_num_objects",
                              64) // 2))
        self.last_credit = 0
        #: wait_any subscribers: Events set on every readiness edge
        #: (item buffered, EOF, failure, close)
        self._waiters: List[threading.Event] = []

    def _wake_waiters_locked(self) -> None:
        for ev in self._waiters:
            ev.set()

    def add_waiter(self, ev: threading.Event) -> None:
        with self.cond:
            self._waiters.append(ev)

    def remove_waiter(self, ev: threading.Event) -> None:
        with self.cond:
            try:
                self._waiters.remove(ev)
            except ValueError:
                pass

    # ------------------------------------------------------- report side
    def on_item(self, index: int, meta: dict, producer: Optional[bytes]
                ) -> None:
        """Pump-thread: one item report arrived. Seeds the owner's meta
        table (so a plain ``get`` on the ref resolves) and mints the
        stream-owned ref — exactly once per index, however many times a
        retransmit or lineage replay re-reports it."""
        rt = self.runtime
        b = meta["object_id"]
        drop_now = False
        with self.cond:
            if producer is not None:
                self.producer = producer
            already_consumed = index < self.next_index
            # "never minted" == not consumed and not buffered. This must
            # NOT be a high-water-mark test: a chaos-delayed item can
            # arrive AFTER its younger siblings, and treating it as a
            # duplicate would leave a permanent gap the consumer hangs on.
            first_sighting = not already_consumed \
                and index not in self.items
            self.received_max = max(self.received_max, index)
        if not first_sighting and not already_consumed:
            # buffered duplicate: meta already seeded, ref already minted
            return
        inline_local = rt._owner_local and meta.get("inline") is not None \
            and meta.get("error") is None
        oid = ObjectID(b)
        if first_sighting:
            rc = rt.reference_counter
            if inline_local:
                # owner-local item: no controller entry, no deltas —
                # suppression must precede the ref's +1 (mirror of put())
                rc.mark_untracked(oid)
            ref = ObjectRef(oid, rt.worker_id, _register=False)
            rc.add_local_reference(ref)
            ref._registered = True
        with rt._meta_lock:
            rt._meta[b] = meta
            if inline_local:
                rt._local_objects[b] = None
        from ray_tpu_torch.core.runtime import _MetaReady
        rt.memory_store.put(oid, _MetaReady(meta), force=True)
        if not first_sighting:
            # replay of a consumed index (lineage re-execution): meta
            # refreshed. Re-send the cumulative credit to the NEW
            # producer — its window opens from zero, and the consumer
            # will never re-consume these indices, so without this a
            # replay with window <= consumed deadlocks at the window.
            with self.cond:
                consumed = self.next_index - 1
                producer = self.producer
                self.last_credit = consumed
            rt._stream_send_credit(self.task_id_b, consumed, producer,
                                   self.trace)
            return
        with self.cond:
            if self.closed:
                drop_now = True  # late item on a cancelled stream
            else:
                self.items[index] = ref
                self.cond.notify_all()
                self._wake_waiters_locked()
        if drop_now:
            # the +1/-1 pair nets to a 0-delta for tracked items, so the
            # controller still learns the object lived and died
            del ref

    def on_eof(self, count: int, producer: Optional[bytes]) -> None:
        with self.cond:
            if producer is not None:
                self.producer = producer
            # first EOF wins: a replayed generator cancelled early (or
            # a duplicate execution) must not shrink the stream
            if self.eof_index is None:
                self.eof_index = count
            self.cond.notify_all()
            self._wake_waiters_locked()

    def fail(self, err: BaseException) -> None:
        """Terminal task failure with no more replays coming: every
        blocked and future ``next()`` raises ``err``."""
        with self.cond:
            if self.error is None:
                self.error = err
            self.cond.notify_all()
            self._wake_waiters_locked()

    # ------------------------------------------------------ consumer side
    def _done_locked(self) -> bool:
        return self.eof_index is not None and self.next_index > self.eof_index

    def next_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """Block until the next in-order item is available and transfer
        its ref to the caller. Raises ``StopIteration`` at EOF, the
        stream error on terminal failure, ``GetTimeoutError`` on
        timeout."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self.cond:
            while True:
                if self.closed:
                    from ray_tpu_torch.exceptions import StreamCancelledError
                    raise StreamCancelledError(TaskID(self.task_id_b))
                ref = self.items.pop(self.next_index, None)
                if ref is not None:
                    self.next_index += 1
                    consumed = self.next_index - 1
                    producer = self.producer
                    # batched credits: flush when the buffer drained
                    # (producer may be window-blocked) or every
                    # credit_batch items; skipped credits are covered
                    # by the next flush (cumulative).
                    send_credit = (not self.items) or \
                        consumed - self.last_credit >= self.credit_batch
                    if send_credit:
                        self.last_credit = consumed
                    break
                if self._done_locked():
                    # fully consumed: the runtime can forget the routing
                    # record (late lineage replays seed metas without it)
                    self.runtime._stream_finished(self.task_id_b)
                    raise StopIteration
                if self.error is not None:
                    raise fresh_error(self.error)
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    from ray_tpu_torch.exceptions import GetTimeoutError
                    raise GetTimeoutError(
                        f"no stream item within {timeout}s")
                self.cond.wait(0.2 if remaining is None
                               else min(0.2, remaining))
        if send_credit:
            self.runtime._stream_send_credit(self.task_id_b, consumed,
                                             producer, self.trace)
        return ref

    def next_ready(self, timeout: Optional[float] = None) -> bool:
        """Wait until the next item is ready (or the stream is done /
        failed) WITHOUT consuming it. Returns True when ``next_ref``
        would return immediately, False on timeout."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self.cond:
            while True:
                if self.closed or self.next_index in self.items \
                        or self._done_locked() or self.error is not None:
                    return True
                remaining = None if deadline is None \
                    else deadline - _time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self.cond.wait(0.2 if remaining is None
                               else min(0.2, remaining))

    def close(self) -> list:
        """Mark closed and strip the buffered refs out (the runtime
        drops them and cancels the producer). Idempotent."""
        with self.cond:
            if self.closed:
                return []
            self.closed = True
            refs = list(self.items.values())
            self.items.clear()
            self.cond.notify_all()
            self._wake_waiters_locked()
            return refs

    def finished(self) -> bool:
        with self.cond:
            return self.closed or self.error is not None \
                or self._done_locked()


class ObjectRefGenerator:
    """Caller-facing handle of a streaming task (reference:
    ``ObjectRefGenerator``, python/ray/_raylet.pyx). Iterating yields
    ``ObjectRef``s in the producer's yield order; ``ray_tpu_torch.get`` each
    to materialize (a mid-stream exception is delivered as the failing
    item — its ``get`` raises). Supports sync and async iteration,
    next-ready waiting, and early termination via ``close()``."""

    def __init__(self, state: StreamState):
        self._state = state

    # -------------------------------------------------------------- sync
    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        return self._state.next_ref()

    def next_ref(self, timeout: Optional[float] = None) -> ObjectRef:
        """``__next__`` with a timeout (``GetTimeoutError`` on expiry)."""
        return self._state.next_ref(timeout)

    def next_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the next item is available (or the stream has
        ended) without consuming it; False on timeout."""
        return self._state.next_ready(timeout)

    def ready_refs(self, max_items: Optional[int] = None) -> List[ObjectRef]:
        """Drain every already-buffered in-order item WITHOUT blocking
        (at most ``max_items``). A fan-in consumer woken by ``wait_any``
        uses this to take a producer's whole burst in one pass instead
        of one wakeup per item. Returns possibly-empty; EOF/failure are
        NOT consumed here — the next ``next_ref()`` surfaces them."""
        out: List[ObjectRef] = []
        st = self._state
        while max_items is None or len(out) < max_items:
            with st.cond:
                if st.closed or st.next_index not in st.items:
                    break
            try:
                out.append(st.next_ref(timeout=0))
            except Exception:
                break
        return out

    # ------------------------------------------------------------- async
    def __aiter__(self) -> "ObjectRefGenerator":
        return self

    async def __anext__(self) -> ObjectRef:
        import asyncio
        loop = asyncio.get_event_loop()
        sentinel = object()

        def pull():
            try:
                return self._state.next_ref()
            except StopIteration:
                # StopIteration must not cross the executor future (it
                # would be swallowed into a RuntimeError inside the
                # coroutine machinery)
                return sentinel

        out = await loop.run_in_executor(None, pull)
        if out is sentinel:
            raise StopAsyncIteration
        return out

    # ---------------------------------------------------------- control
    def task_id(self) -> TaskID:
        return TaskID(self._state.task_id_b)

    def is_finished(self) -> bool:
        """True when the stream can yield nothing further (EOF reached
        and consumed, terminally failed, or cancelled)."""
        return self._state.finished()

    def close(self) -> None:
        """Early termination: cancel the producer task and drop every
        buffered (unconsumed) item ref. Safe to call repeatedly."""
        self._state.runtime._close_stream(self._state)

    cancel = close

    def __del__(self):
        try:
            if not self._state.finished():
                self.close()
        except Exception:
            pass

    def __reduce__(self):
        raise TypeError(
            "ObjectRefGenerator is not serializable: it is owned by the "
            "submitting process (pass the consumed values, or the item "
            "ObjectRefs, instead)")

    def __repr__(self):
        return f"ObjectRefGenerator({TaskID(self._state.task_id_b).hex()[:16]})"


def wait_any(generators: Sequence[ObjectRefGenerator],
             timeout: Optional[float] = None, num_returns: int = 1
             ) -> Tuple[List[ObjectRefGenerator],
                        List[ObjectRefGenerator]]:
    """Block until at least ``num_returns`` of ``generators`` are
    *actionable* — their next ``next_ref()`` would return (an in-order
    item is buffered) or terminate immediately (EOF fully consumed,
    terminal failure, cancelled). Returns ``(ready, not_ready)`` in the
    input order, like ``ray_tpu_torch.wait`` for plain refs; on timeout the
    ready list may be shorter than ``num_returns`` (possibly empty).

    Event-driven, not polling: every stream wakes a shared Event on its
    readiness edges (item report, EOF, failure, close), so a fan-in
    consumer — e.g. the MPMD 1F1B scheduler draining one stream per
    pipeline stage — reacts at delivery latency regardless of how many
    streams it watches.
    """
    gens = list(generators)
    if not gens:
        return [], []
    num_returns = max(1, min(num_returns, len(gens)))
    import time as _time
    deadline = None if timeout is None else _time.monotonic() + timeout
    ev = threading.Event()
    for g in gens:
        g._state.add_waiter(ev)
    try:
        while True:
            ready = [g for g in gens if g._state.next_ready(timeout=0)]
            if len(ready) >= num_returns:
                break
            remaining = None if deadline is None \
                else deadline - _time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            ev.wait(0.2 if remaining is None else min(0.2, remaining))
            ev.clear()
    finally:
        for g in gens:
            g._state.remove_waiter(ev)
    ready_ids = {id(g) for g in ready}
    return ready, [g for g in gens if id(g) not in ready_ids]
