"""Shared-memory object store: the plasma equivalent.

Design (vs. reference ``src/ray/object_manager/plasma/``): plasma is a
store *server* inside the raylet serving clients over a unix socket with fd
passing (``fling.cc``); objects live in mmap'd segments carved by dlmalloc.
Here every node has a session directory under ``/dev/shm``; each sealed
object is one mmap'd file named by its ObjectID hex. Clients attach by name
— same zero-copy property (page-cache-shared mappings), no fd passing
needed. Create/Seal/Get/Release/Delete semantics and LRU eviction with
ref pinning match ``object_lifecycle_manager.h`` / ``eviction_policy.h``;
capacity overflow falls back to a disk directory (plasma "fallback
allocation") and spilling (``local_object_manager.h:41``).

An optional C++ slab allocator (ray_tpu_torch/_native) accelerates small-object
placement; the mmap layout is identical so readers are agnostic.
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError

_SHM_ROOT = "/dev/shm"


class _Mapped:
    __slots__ = ("mm", "view", "size", "path")

    def __init__(self, path: str, size: int, create: bool):
        self.path = path
        self.size = size
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.view = memoryview(self.mm)

    def close(self):
        try:
            self.view.release()
        except Exception:
            pass
        try:
            self.mm.close()
        except Exception:
            pass


class ShmObjectStore:
    """Node-local store. One instance lives in the node manager process
    (the authority for eviction); workers use `ShmClient` views keyed by the
    same session name."""

    def __init__(self, session_name: str, capacity_bytes: int,
                 spill_dir: Optional[str] = None):
        self.session_name = session_name
        self.dir = os.path.join(_SHM_ROOT, session_name)
        os.makedirs(self.dir, exist_ok=True)
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._used = 0
        # LRU order: oldest first (reference: eviction_policy.h LRUCache)
        self._sealed: "OrderedDict[ObjectID, int]" = OrderedDict()
        self._pinned: Dict[ObjectID, int] = {}
        self._spilled: Dict[ObjectID, str] = {}

    # --- server-side bookkeeping (node manager) ---
    def on_sealed(self, object_id: ObjectID, size: int,
                  grace: bool = False) -> None:
        # ``grace`` (fresh-arrival spill grace) is a NativeShmStore
        # refinement; the python fallback store accepts and ignores it
        with self._lock:
            self._sealed[object_id] = size
            self._used += size
            self._maybe_evict_locked()

    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            self._pinned[object_id] = self._pinned.get(object_id, 0) + 1

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            n = self._pinned.get(object_id, 0) - 1
            if n <= 0:
                self._pinned.pop(object_id, None)
            else:
                self._pinned[object_id] = n

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._sealed or object_id in self._spilled

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._delete_locked(object_id)

    def _delete_locked(self, object_id: ObjectID) -> None:
        size = self._sealed.pop(object_id, None)
        if size is not None:
            self._used -= size
            try:
                os.unlink(self._path(object_id))
            except FileNotFoundError:
                pass
        spath = self._spilled.pop(object_id, None)
        if spath:
            try:
                os.unlink(spath)
            except FileNotFoundError:
                pass

    def _maybe_evict_locked(self) -> None:
        """Evict-by-spill LRU unpinned objects when over capacity."""
        if self._used <= self.capacity:
            return
        for oid in list(self._sealed.keys()):
            if self._used <= self.capacity:
                break
            if oid in self._pinned:
                continue
            if self.spill_dir:
                self._spill_locked(oid)
            else:
                self._delete_locked(oid)

    def _spill_locked(self, object_id: ObjectID) -> None:
        size = self._sealed.get(object_id)
        if size is None:
            return
        src = self._path(object_id)
        dst = os.path.join(self.spill_dir, object_id.hex())
        try:
            os.replace(src, dst) if os.stat(src).st_dev == os.stat(self.spill_dir).st_dev \
                else self._copy_spill(src, dst)
        except OSError:
            self._copy_spill(src, dst)
        self._sealed.pop(object_id, None)
        self._used -= size
        self._spilled[object_id] = dst

    @staticmethod
    def _copy_spill(src: str, dst: str) -> None:
        with open(src, "rb") as f, open(dst, "wb") as g:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                g.write(chunk)
        os.unlink(src)

    def maybe_evict(self) -> None:
        """Background spill/eviction toward the budget (node heartbeat)."""
        with self._lock:
            self._maybe_evict_locked()

    def make_room(self, bytes_needed: int) -> int:
        """Spill/evict LRU unpinned objects until ``bytes_needed`` of
        capacity is free (see NativeShmStore.make_room)."""
        freed = 0
        with self._lock:
            for oid in list(self._sealed.keys()):
                if self.capacity - self._used >= bytes_needed:
                    break
                if oid in self._pinned:
                    continue
                size = self._sealed.get(oid, 0)
                if self.spill_dir:
                    self._spill_locked(oid)
                else:
                    self._delete_locked(oid)
                freed += size
        return freed

    def maybe_restore(self, object_id: ObjectID) -> bool:
        """Restore a spilled object back into shm (reference:
        local_object_manager.h AsyncRestoreSpilledObject)."""
        with self._lock:
            spath = self._spilled.get(object_id)
            if spath is None:
                return object_id in self._sealed
            size = os.stat(spath).st_size
            m = _Mapped(self._path(object_id), size, create=True)
            with open(spath, "rb") as f:
                f.readinto(m.view)
            m.close()
            os.unlink(spath)
            self._spilled.pop(object_id, None)
            self._sealed[object_id] = size
            self._used += size
            return True

    def contents(self):
        """[(object_id_binary, size)] of every sealed (incl. spilled)
        object — the node re-announces these to a restarted controller."""
        with self._lock:
            out = [(oid.binary(), sz) for oid, sz in self._sealed.items()]
            out.extend((oid.binary(), 0) for oid in self._spilled)
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "used_bytes": self._used,
                "capacity_bytes": self.capacity,
                "num_objects": len(self._sealed),
                "num_spilled": len(self._spilled),
                "num_pinned": len(self._pinned),
            }

    def _path(self, object_id: ObjectID) -> str:
        return os.path.join(self.dir, object_id.hex())

    def destroy(self) -> None:
        with self._lock:
            for oid in list(self._sealed.keys()) + list(self._spilled.keys()):
                self._delete_locked(oid)
        try:
            os.rmdir(self.dir)
        except OSError:
            pass


def make_store(session_name: str, capacity_bytes: int,
               spill_dir: Optional[str] = None):
    """Store factory: native C++ segment when buildable, else the
    Python file-per-object store."""
    from ray_tpu_torch import _native
    if _native.load() is not None:
        try:
            from ray_tpu_torch.core.native_store import NativeShmStore
            return NativeShmStore(session_name, capacity_bytes,
                                  spill_dir=spill_dir)
        except OSError:
            pass
    return ShmObjectStore(session_name, capacity_bytes,
                          spill_dir=spill_dir)


def make_client(session_name: str):
    """Client factory: the segment file's existence marks a native-store
    session (the node manager creates it before workers/drivers join)."""
    from ray_tpu_torch import _native
    seg = os.path.join(_SHM_ROOT, f"{session_name}.seg")
    if os.path.exists(seg) and _native.load() is not None:
        from ray_tpu_torch.core.native_store import NativeShmClient
        return NativeShmClient(session_name)
    return ShmClient(session_name)


class ShmClient:
    """Worker/driver-side client: create+seal and zero-copy get by name.

    Equivalent of ``plasma::PlasmaClient`` (plasma/client.h). Attach is by
    filename under the session shm dir; mappings are cached per process.
    """

    def __init__(self, session_name: str):
        self.dir = os.path.join(_SHM_ROOT, session_name)
        self._mapped: Dict[ObjectID, _Mapped] = {}
        self._lock = threading.Lock()

    def _path(self, object_id: ObjectID) -> str:
        return os.path.join(self.dir, object_id.hex())

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        if size == 0:
            size = 1
        m = _Mapped(self._path(object_id) + ".building", size, create=True)
        with self._lock:
            self._mapped[object_id] = m
        return m.view

    def seal(self, object_id: ObjectID) -> int:
        """Atomically publish the object (rename building -> final)."""
        os.replace(self._path(object_id) + ".building", self._path(object_id))
        with self._lock:
            m = self._mapped.get(object_id)
        return m.size if m else 0

    def put_bytes(self, object_id: ObjectID, data) -> int:
        view = self.create(object_id, len(data))
        view[: len(data)] = data
        return self.seal(object_id)

    def get_view(self, object_id: ObjectID, timeout: float = 0.0) -> Optional[memoryview]:
        """Zero-copy view of a sealed object; None if absent."""
        with self._lock:
            m = self._mapped.get(object_id)
            if m is not None:
                return m.view
        path = self._path(object_id)
        deadline = time.monotonic() + timeout
        while True:
            try:
                size = os.stat(path).st_size
                m = _Mapped(path, size, create=False)
                with self._lock:
                    self._mapped[object_id] = m
                return m.view
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.001)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            if object_id in self._mapped:
                return True
        return os.path.exists(self._path(object_id))

    def release(self, object_id: ObjectID) -> None:
        with self._lock:
            m = self._mapped.pop(object_id, None)
        if m is not None:
            m.close()

    def close(self) -> None:
        with self._lock:
            for m in self._mapped.values():
                m.close()
            self._mapped.clear()
