"""Reference counting for distributed GC.

The reference implements fully decentralized ownership with a borrowing
protocol (``src/ray/core_worker/reference_count.h:61``): each object's owner
tracks borrowers via pubsub (WaitForRefRemoved). This build keeps the same
*observable* semantics (objects live while any process holds a ref or an
in-flight task depends on them; freed when the last ref dies) with a
single-controller accounting design: every process runs a local
``ReferenceCounter`` that batches count deltas to the controller, which is
the authority that triggers deletion when an object's global count reaches
zero. Contained refs discovered during (de)serialization produce the same
delta messages a borrow registration would.

Rationale: the control plane here is already a single authority (GCS-
equivalent); piggy-backing GC on it removes the hardest distributed
protocol in the reference while preserving the API contract. Lineage
pinning (``task_manager.h:432``) lives controller-side as well.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core.ids import ObjectID


class ReferenceCounter:
    """Process-local counts + batched delta reporting."""

    def __init__(self, flush_fn: Optional[Callable[[Dict[bytes, int]], None]] = None):
        self._lock = threading.Lock()
        self._local: Dict[ObjectID, int] = {}
        # counts of in-flight task submissions using this ref as an arg
        self._submitted: Dict[ObjectID, int] = {}
        self._pending_deltas: Dict[bytes, int] = {}
        self._flush_fn = flush_fn
        self._flush_threshold = 256
        # fired (outside the lock) when an object's combined local +
        # submitted count drops to zero — the owner's eager-free hook
        self._on_owner_zero: Optional[Callable[[ObjectID], None]] = None
        # decrefs from ObjectRef.__del__ — GC can run __del__ on the
        # thread that already holds _lock (mid-_delta dict op), so
        # __del__ must never lock: it appends here (GIL-atomic) and the
        # next locked operation drains the queue
        self._deferred_decrefs: "deque[ObjectID]" = deque()
        #: owner-local objects (reference: in-process store objects the
        #: GCS never hears about): counts are kept locally but produce NO
        #: controller deltas until promoted (ref escape / controller-path
        #: submit). Keyed by object id binary.
        self._untracked: set = set()

    def set_flush_fn(self, fn: Callable[[Dict[bytes, int]], None]) -> None:
        self._flush_fn = fn

    def set_owner_zero_fn(self, fn: Callable[[ObjectID], None]) -> None:
        self._on_owner_zero = fn

    # -- ObjectRef lifecycle hooks --
    def add_local_reference(self, ref) -> None:
        self._delta(ref.id(), +1, self._local)

    def remove_local_reference(self, ref) -> None:
        # __del__-safe: lock-free defer (see _deferred_decrefs)
        self._deferred_decrefs.append(ref.id())

    # -- task submission pinning --
    def add_submitted_task_ref(self, object_id: ObjectID) -> None:
        self._delta(object_id, +1, self._submitted)

    def remove_submitted_task_ref(self, object_id: ObjectID) -> None:
        self._delta(object_id, -1, self._submitted)

    def _apply_locked(self, object_id: ObjectID, d: int,
                      table: Dict[ObjectID, int],
                      zeros: List[ObjectID]) -> None:
        """Apply one delta. Caller holds the lock; owner-zero events are
        appended to ``zeros`` and must be fired after release."""
        n = table.get(object_id, 0) + d
        if n <= 0:
            table.pop(object_id, None)
        else:
            table[object_id] = n
        key = object_id.binary()
        untracked = key in self._untracked
        if d < 0 and n <= 0 \
                and self._local.get(object_id, 0) == 0 \
                and self._submitted.get(object_id, 0) == 0:
            zeros.append(object_id)
            if untracked:
                # fully dead: no promotion record needed, set stays bounded
                self._untracked.discard(key)
        if untracked:
            return
        # A +1/-1 pair inside one flush window still nets to a 0-delta
        # entry that MUST be flushed: dropping it would hide the
        # object's entire lifecycle from the controller (never "ever
        # positive" -> its entry and shm extent would leak forever).
        self._pending_deltas[key] = \
            self._pending_deltas.get(key, 0) + d

    def _drain_deferred_locked(self, zeros: List[ObjectID]) -> None:
        while True:
            try:
                oid = self._deferred_decrefs.popleft()
            except IndexError:
                return
            self._apply_locked(oid, -1, self._local, zeros)

    def _fire(self, flush: Optional[Dict[bytes, int]],
              zeros: List[ObjectID]) -> None:
        if flush and self._flush_fn:
            self._flush_fn(flush)
        if zeros and self._on_owner_zero is not None:
            for oid in zeros:
                self._on_owner_zero(oid)

    def _delta(self, object_id: ObjectID, d: int, table: Dict[ObjectID, int]) -> None:
        flush = None
        zeros: List[ObjectID] = []
        with self._lock:
            self._drain_deferred_locked(zeros)
            self._apply_locked(object_id, d, table, zeros)
            if len(self._pending_deltas) >= self._flush_threshold:
                flush = self._pending_deltas
                self._pending_deltas = {}
        self._fire(flush, zeros)

    # -- owner-local (untracked) objects --
    def mark_untracked(self, object_id: ObjectID) -> None:
        """Suppress controller deltas for this object: the owner tracks it
        locally only. Must be called BEFORE the first add_local_reference
        for the object."""
        with self._lock:
            self._untracked.add(object_id.binary())

    def is_untracked(self, object_id_b: bytes) -> bool:
        with self._lock:
            return object_id_b in self._untracked

    def promote(self, object_id: ObjectID) -> int:
        """Stop suppressing deltas and inject the object's CURRENT live
        count as one pending delta, so the controller's table picks up as
        if it had been tracked from the start. Returns the injected count,
        or -1 if the object was not untracked (already promoted / never
        suppressed). An injected 0 is meaningful: it tells the controller
        the object lived and fully died (frees the directory entry)."""
        flush = None
        zeros: List[ObjectID] = []
        with self._lock:
            self._drain_deferred_locked(zeros)
            key = object_id.binary()
            if key not in self._untracked:
                n = -1
            else:
                self._untracked.discard(key)
                n = self._local.get(object_id, 0) + \
                    self._submitted.get(object_id, 0)
                self._pending_deltas[key] = \
                    self._pending_deltas.get(key, 0) + n
                if len(self._pending_deltas) >= self._flush_threshold:
                    flush = self._pending_deltas
                    self._pending_deltas = {}
        self._fire(flush, zeros)
        return n

    def flush(self) -> None:
        zeros: List[ObjectID] = []
        with self._lock:
            self._drain_deferred_locked(zeros)
            deltas = self._pending_deltas
            self._pending_deltas = {}
        self._fire(deltas or None, zeros)

    def local_count(self, object_id: ObjectID) -> int:
        zeros: List[ObjectID] = []
        with self._lock:
            self._drain_deferred_locked(zeros)
            n = self._local.get(object_id, 0) + \
                self._submitted.get(object_id, 0)
        self._fire(None, zeros)
        return n

    def all_counts(self) -> Dict[bytes, int]:
        """Aggregate live counts, for re-seeding a restarted controller's
        global table (its counts died with it)."""
        zeros: List[ObjectID] = []
        with self._lock:
            self._drain_deferred_locked(zeros)
            out: Dict[bytes, int] = {}
            for table in (self._local, self._submitted):
                for oid, n in table.items():
                    b = oid.binary()
                    if b in self._untracked:
                        continue  # owner-local: the controller never
                        # tracked it and must not start now
                    out[b] = out.get(b, 0) + n
        self._fire(None, zeros)
        return out


class GlobalRefTable:
    """Controller-side aggregate (the deletion authority).

    Tracks per-object: global refcount, owner, locations, lineage task, and
    a lineage pin while any downstream object might need reconstruction.
    """

    def __init__(self, on_zero: Callable[[ObjectID], None]):
        self._lock = threading.Lock()
        self._counts: Dict[bytes, int] = {}
        self._ever_positive: Dict[bytes, bool] = {}
        #: Recently-released ids (bounded FIFO). Needed because a worker's
        #: TASK_DONE races the owner's release deltas on separate sockets:
        #: without a tombstone the controller would resurrect an object
        #: entry whose refcount already hit zero and pin its shm extent
        #: forever (the zero event never fires twice).
        self._released: "OrderedDict[bytes, None]" = OrderedDict()
        self._released_cap = 65536
        self._on_zero = on_zero
        #: what each process's deltas net to, by object: the refs it
        #: holds as far as the controller heard. A dead process's are
        #: released (:meth:`release_holder`), and its late deltas dropped.
        self._held: Dict[bytes, Dict[bytes, int]] = {}
        self._dead: "OrderedDict[bytes, None]" = OrderedDict()

    def apply_deltas(self, deltas: Dict[bytes, int],
                     holder: Optional[bytes] = None) -> None:
        zeroed = []
        with self._lock:
            if holder is not None:
                if holder in self._dead:
                    return   # released at its death
                held = self._held.setdefault(holder, {})
                for key, d in deltas.items():
                    n = held.get(key, 0) + d
                    if n:
                        held[key] = n
                    else:
                        held.pop(key, None)
            for key, d in deltas.items():
                n = self._counts.get(key, 0) + d
                if d >= 0:
                    # d == 0 is a client-side netted +1/-1 pair: the
                    # object existed and was fully dropped within one
                    # flush window — it must still count as having been
                    # referenced, or its entry never becomes freeable
                    self._ever_positive[key] = True
                if n <= 0:
                    self._counts.pop(key, None)
                    if self._ever_positive.pop(key, False):
                        zeroed.append(ObjectID(key))
                        self._released[key] = None
                        while len(self._released) > self._released_cap:
                            self._released.popitem(last=False)
                else:
                    self._counts[key] = n
                    self._released.pop(key, None)
        for oid in zeroed:
            self._on_zero(oid)

    def release_holder(self, holder: bytes) -> None:
        """A process died: drop every count its deltas still hold, as
        though it had dropped each ref, and ignore what it sent that
        arrives later."""
        with self._lock:
            held = self._held.pop(holder, {})
            self._dead[holder] = None
            while len(self._dead) > 4096:
                self._dead.popitem(last=False)
        self.apply_deltas({k: -n for k, n in held.items() if n > 0})

    def is_dead(self, holder: bytes) -> bool:
        with self._lock:
            return holder in self._dead

    def cancel_release(self, object_id_b: bytes) -> None:
        """Undo a zero-event's tombstone: the controller decided the
        object must live (active waiters hold refs whose deltas are
        still in flight). Without this, the tombstone makes
        _h_task_done discard the object's upcoming location records."""
        with self._lock:
            self._released.pop(object_id_b, None)

    def force_release(self, object_id_b: bytes) -> bool:
        """Owner-side eager free: drop this object's counts and tombstone
        it so late deltas / completion records can't resurrect it.
        Returns False if it was already released."""
        with self._lock:
            if object_id_b in self._released:
                return False
            self._counts.pop(object_id_b, None)
            self._ever_positive.pop(object_id_b, None)
            self._released[object_id_b] = None
            while len(self._released) > self._released_cap:
                self._released.popitem(last=False)
            return True

    def is_released(self, object_id_b: bytes) -> bool:
        """True if this object's refcount already hit zero (it must not be
        resurrected by a late completion record)."""
        with self._lock:
            return object_id_b in self._released

    def count(self, object_id: ObjectID) -> int:
        with self._lock:
            return self._counts.get(object_id.binary(), 0)

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._counts)
