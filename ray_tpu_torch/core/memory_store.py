"""In-process memory store for small objects and pending futures.

Equivalent of the reference's ``CoreWorkerMemoryStore``
(``src/ray/core_worker/store_provider/memory_store/memory_store.h:43``):
holds small/direct task returns and unresolved futures; ``get`` blocks until
the object arrives or errors. Objects above the inline threshold live in the
shared-memory store instead (dual-path ``GetImpl``, memory_store.cc).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core.ids import ObjectID


class WeakExpired:
    """Sentinel handed to on_ready callbacks whose weak-cached value was
    collected: the receiver re-materializes from shared memory."""

    __slots__ = ()


class WeakCacheExpired(Exception):
    """A blocking get hit a weak cache entry whose value was collected:
    the object still exists in shm — the caller re-materializes instead
    of treating this as a timeout or failure."""


_WEAK_EXPIRED = WeakExpired()


def fresh_error(err: BaseException) -> BaseException:
    """A copy of a stored error, to raise in its place. A raised exception
    takes a traceback of every frame it passes through; raised from the
    store itself, it would keep those frames, and all their locals, alive
    for as long as its entry lives (an elastic trainer's snapshot, pinned
    in the shared-memory store, was one such local)."""
    try:
        return copy.copy(err)
    except Exception:
        return err.with_traceback(None)


class _Entry:
    __slots__ = ("value", "error", "ready", "weak")

    def __init__(self):
        self.value = None
        self.error: Optional[BaseException] = None
        self.ready = False
        self.weak = False

    def live_value(self):
        """(alive, value): weak entries whose target was collected are
        dead — the caller re-materializes from shm."""
        if not self.weak:
            return True, self.value
        v = self.value()
        return (v is not None), v


class InProcessStore:
    def __init__(self):
        self._lock = threading.Condition()
        self._objects: Dict[ObjectID, _Entry] = {}
        self._callbacks: Dict[ObjectID, List[Callable]] = {}

    def put(self, object_id: ObjectID, value, error: Optional[BaseException] = None,
            force: bool = False, weak: bool = False) -> None:
        """``weak=True`` caches a weakref: large shm-materialized values
        must not be pinned by the cache beyond their user's lifetime —
        the reader-ledger release (and therefore extent reuse) is tied
        to the value's GC (reference: plasma buffers are pinned by the
        client only while Python holds them)."""
        import weakref
        if weak:
            try:
                stored = weakref.ref(value)
            except TypeError:
                stored, weak = value, False
        else:
            stored = value
        with self._lock:
            e = self._objects.setdefault(object_id, _Entry())
            if e.ready and not force:
                return  # idempotent (retries may double-complete)
            e.value = stored
            e.error = error
            e.ready = True
            e.weak = weak
            callbacks = self._callbacks.pop(object_id, [])
            self._lock.notify_all()
        for cb in callbacks:
            cb(value, error)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._objects.get(object_id)
            if e is None or not e.ready:
                return False
            alive, _ = e.live_value()
            if not alive:
                del self._objects[object_id]
                return False
            return True

    def get(self, object_id: ObjectID, timeout: Optional[float] = None):
        """Blocks; returns value or raises the stored error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                e = self._objects.get(object_id)
                if e is not None and e.ready:
                    if e.error is not None:
                        raise fresh_error(e.error)
                    alive, v = e.live_value()
                    if not alive:
                        # collected weak value: the caller re-derives it
                        # from shm via the meta path
                        del self._objects[object_id]
                        raise WeakCacheExpired(str(object_id))
                    return v
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    from ray_tpu_torch.exceptions import GetTimeoutError
                    raise GetTimeoutError(f"timed out waiting for {object_id}")
                if not self._lock.wait(timeout=remaining if remaining is None or remaining < 0.2 else 0.2):
                    pass

    def try_get(self, object_id: ObjectID):
        """Non-blocking; returns (found, value_or_error_raised)."""
        with self._lock:
            e = self._objects.get(object_id)
            if e is None or not e.ready:
                return False, None
            if e.error is not None:
                raise fresh_error(e.error)
            alive, v = e.live_value()
            if not alive:
                del self._objects[object_id]
                return False, None
            return True, v

    def on_ready(self, object_id: ObjectID, callback: Callable) -> None:
        with self._lock:
            e = self._objects.get(object_id)
            if e is not None and e.ready:
                alive, value = e.live_value()
                error = e.error
                if not alive and error is None:
                    # collected weak value: completion already happened;
                    # the receiver re-derives the value from shm
                    del self._objects[object_id]
                    value = _WEAK_EXPIRED
            else:
                self._callbacks.setdefault(object_id, []).append(callback)
                return
        callback(value, error)

    def remove_callback(self, object_id: ObjectID, callback: Callable) -> None:
        """Unregister an ``on_ready`` hook (waiters with expired timeouts)."""
        with self._lock:
            lst = self._callbacks.get(object_id)
            if lst is None:
                return
            try:
                lst.remove(callback)
            except ValueError:
                pass
            if not lst:
                self._callbacks.pop(object_id, None)

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._objects.pop(object_id, None)
            self._callbacks.pop(object_id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
