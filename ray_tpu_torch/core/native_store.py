"""Native-segment store/client: same API as ShmObjectStore/ShmClient,
backed by the C++ single-segment allocator (``ray_tpu_torch/_native``).

One ``/dev/shm/<session>.seg`` holds the index + all object bytes, so
create/seal/contains are shared-memory operations instead of per-object
``open``/``ftruncate``/``mmap`` syscalls (the plasma property —
``plasma_allocator.h`` — that the pure-Python store approximates with
one file per object). Eviction/spill policy stays in the Python store
class: the segment is the data plane.
"""

from __future__ import annotations

import ctypes
import errno
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import logging

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError

logger = logging.getLogger(__name__)

#: RAY_TPU_TORCH_STORE_DEBUG=1 logs object lifecycle decisions with full ids
#: (spill/restore/delete forensics; analog of plasma's debug-level
#: object-lifecycle logging)
STORE_DEBUG = os.environ.get("RAY_TPU_TORCH_STORE_DEBUG") == "1"

_SHM_ROOT = "/dev/shm"
_FULL = 2 ** 64 - 1
_EXISTS = 2 ** 64 - 2

_PAGE = 4096
_MADV_POPULATE_READ = 22   # linux 5.14+: prefault + PTE setup in one call
_MADV_POPULATE_WRITE = 23
_PROT_READ_WRITE = 0x3
_MAP_SHARED_FIXED_POPULATE = 0x01 | 0x10 | 0x8000
_libc = ctypes.CDLL(None, use_errno=True)
_libc.mmap.restype = ctypes.c_void_p
_libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_long]
#: whether madvise(MADV_POPULATE_*) works on this kernel: None until the
#: first populate asks, False where it fails with EINVAL (kernels before
#: 5.14, and sandboxed kernels such as gVisor's)
_madvise_populates: Optional[bool] = None


def _populate(seg: "_Segment", off: int, size: int,
              write: bool = True) -> None:
    """Fault the whole pages of ``[off, off + size)`` of ``seg``'s mapping
    in at once. Writing or reading through fresh tmpfs pages costs a
    trap per 4 KiB (~5x bandwidth loss measured); one madvise populates
    the range at kernel speed, and on resident pages only fills PTEs. Where
    madvise cannot populate, the pages are mapped again in place, over the
    same file range, with ``MAP_POPULATE``: the same memory at the same
    addresses, populated (3.5x the write rate of lazy faults and 2x
    memcpy's on the pages afterwards, measured under gVisor). Only pages
    wholly inside the range are touched, so no other extent's mapping
    moves. Errors leave the pages to fault lazily, as before."""
    global _madvise_populates
    start = (seg.base + off + _PAGE - 1) & ~(_PAGE - 1)
    end = (seg.base + off + size) & ~(_PAGE - 1)
    if end <= start:
        return
    if _madvise_populates is not False:
        rc = _libc.madvise(ctypes.c_void_p(start), ctypes.c_size_t(
            end - start), _MADV_POPULATE_WRITE if write
            else _MADV_POPULATE_READ)
        if rc == 0:
            _madvise_populates = True
            return
        if ctypes.get_errno() != errno.EINVAL or _madvise_populates:
            return
        _madvise_populates = False
    fd = seg.fd()
    if fd is not None:
        _libc.mmap(ctypes.c_void_p(start), ctypes.c_size_t(end - start),
                   _PROT_READ_WRITE, _MAP_SHARED_FIXED_POPULATE, fd,
                   start - seg.base)


def _seg_path(session_name: str) -> str:
    return os.path.join(_SHM_ROOT, f"{session_name}.seg")


class _Segment:
    """One mapped native segment (create or open)."""

    def __init__(self, lib, session_name: str,
                 capacity: Optional[int] = None, nslots: int = 65536):
        self.lib = lib
        self.path = _seg_path(session_name)
        if capacity is not None:
            self.handle = lib.ns_create(
                self.path.encode(), capacity, nslots)
            self.owner = True
        else:
            self.handle = lib.ns_open(self.path.encode())
            self.owner = False
        if not self.handle:
            raise OSError(f"cannot map native segment {self.path}")
        total = lib.ns_total_size(self.handle)
        base = lib.ns_base(self.handle)
        self.base = base
        self.total = total
        self._buf = (ctypes.c_char * total).from_address(base)
        self.view = memoryview(self._buf).cast("B")
        self._fd: Optional[int] = None

    def fd(self) -> Optional[int]:
        """A descriptor of the segment's file (for :func:`_populate`'s
        mapping in place), opened at the first call; None if the file
        is gone."""
        if self._fd is None:
            try:
                self._fd = os.open(self.path, os.O_RDWR)
            except OSError:
                return None
        return self._fd

    def alloc(self, oid: ObjectID, size: int) -> int:
        return self.lib.ns_alloc(self.handle, oid.binary(), size)

    def seal(self, oid: ObjectID) -> int:
        return self.lib.ns_seal(self.handle, oid.binary())

    def lookup(self, oid: ObjectID):
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        state = self.lib.ns_lookup(
            self.handle, oid.binary(), ctypes.byref(off),
            ctypes.byref(size))
        return state, off.value, size.value

    def delete(self, oid: ObjectID) -> int:
        return self.lib.ns_delete(self.handle, oid.binary())

    def evict(self, oid: ObjectID) -> int:
        """Free only if unreferenced (never under a live reader)."""
        return self.lib.ns_evict(self.handle, oid.binary())

    def acquire(self, oid: ObjectID):
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        state = self.lib.ns_acquire(
            self.handle, oid.binary(), os.getpid(), ctypes.byref(off),
            ctypes.byref(size))
        return state, off.value, size.value

    def acquire_for(self, oid: ObjectID, pid: int) -> int:
        """Take a read reference on behalf of ANOTHER process (the
        restore handshake — see NativeShmStore._lease_for_locked).
        Reaped with the rest of the pid's references if it dies."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        return self.lib.ns_acquire(
            self.handle, oid.binary(), pid, ctypes.byref(off),
            ctypes.byref(size))

    def release_for(self, oid: ObjectID, pid: int) -> None:
        self.lib.ns_release(self.handle, oid.binary(), pid)

    def release(self, oid: ObjectID) -> None:
        self.lib.ns_release(self.handle, oid.binary(), os.getpid())

    def release_all(self) -> None:
        self.lib.ns_release_all(self.handle, os.getpid())

    def reap(self) -> int:
        return self.lib.ns_reap(self.handle)

    def largest_free(self) -> int:
        return self.lib.ns_largest_free(self.handle)

    def compact(self) -> int:
        """Defragment movable (sealed, reader-free) extents; returns the
        largest contiguous free run afterwards."""
        return self.lib.ns_compact(self.handle)

    def stats(self):
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        n = ctypes.c_uint32()
        self.lib.ns_stats(self.handle, ctypes.byref(used),
                          ctypes.byref(cap), ctypes.byref(n))
        return used.value, cap.value, n.value

    def list_sealed(self, max_n: Optional[int] = None):
        """[(ObjectID, size, refcnt)] of every sealed object in the
        segment — the authoritative inventory for spill/eviction (the
        index, not notifications, is the source of truth). Buffers are
        sized from the live object count: this runs under the store
        lock on every eviction sweep, so fixed 2.6MB allocations would
        tax exactly the pressure episodes it serves."""
        if max_n is None:
            _, _, n_live = self.stats()
            max_n = max(64, min(65536, int(n_live) + 64))
        ids = (ctypes.c_uint8 * (28 * max_n))()
        sizes = (ctypes.c_uint64 * max_n)()
        refs = (ctypes.c_uint32 * max_n)()
        n = self.lib.ns_list(self.handle, ids, sizes, refs, max_n)
        raw = bytes(ids)
        return [(ObjectID(raw[i * 28:(i + 1) * 28]),
                 sizes[i], refs[i]) for i in range(n)]

    def close(self, unlink: bool = False) -> None:
        try:
            self.view.release()
        except Exception:
            pass
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
        if self.handle:
            self.lib.ns_close(self.handle)
            self.handle = None
        if unlink:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass


class NativeShmStore:
    """Server side (node manager): eviction/spill authority over the
    native segment. API-compatible with ``ShmObjectStore``."""

    def __init__(self, session_name: str, capacity_bytes: int,
                 spill_dir: Optional[str] = None, lib=None):
        from ray_tpu_torch import _native
        self.lib = lib or _native.load()
        assert self.lib is not None
        self.session_name = session_name
        self.capacity = capacity_bytes
        # Physical segment is over-provisioned (tmpfs pages materialize
        # only when touched, so unused headroom costs nothing) — a
        # create that overshoots the nominal capacity succeeds while
        # eviction/spilling works back toward the budget. This is
        # plasma's "fallback allocation" escape valve: the in-flight
        # working set (reader-leased extents of executing tasks) may
        # legitimately exceed the budget, and refusing creates then
        # deadlocks the pipeline that would have released those leases.
        self.seg = _Segment(self.lib, session_name,
                            capacity=capacity_bytes * 4)
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._sealed: "OrderedDict[ObjectID, int]" = OrderedDict()
        self._pinned: Dict[ObjectID, int] = {}
        self._spilled: Dict[ObjectID, str] = {}
        #: consecutive failed restore reads per object (disk faults):
        #: below the cap the failure is reported transient ("retry");
        #: at the cap the backing copy is declared lost so the
        #: controller can re-pull from another holder
        self._restore_strikes: Dict[ObjectID, int] = {}
        #: seeded spill-path fault injection (chaos.py); None in
        #: production — the spill/restore hot path stays untouched
        self._disk_chaos = None
        if spill_dir:
            try:
                from ray_tpu_torch.core import chaos as _chaos
                self._disk_chaos = _chaos.maybe_disk_injector("node")
            except Exception:
                pass
        #: freshly-restored objects are exempt from spilling briefly —
        #: without the grace window, memory pressure can re-spill an
        #: object between its restore RPC reply and the requester's
        #: first read lease (restore/spill livelock)
        self._restore_grace: Dict[ObjectID, float] = {}
        # Background prefault (bounded): once tmpfs pages exist, every
        # client mapping reaches memcpy-class put bandwidth; unfaulted
        # tails are handled per-create by _populate.
        from ray_tpu_torch.core.config import get_config
        budget = min(self.seg.total,
                     get_config().object_store_prefault_bytes)
        if budget > 0:
            t = threading.Thread(target=self._prefault, args=(budget,),
                                 name="store-prefault", daemon=True)
            t.start()

    def _prefault(self, budget: int) -> None:
        chunk = 256 << 20
        for off in range(0, budget, chunk):
            if self.seg.handle is None:
                return
            _populate(self.seg, off,
                              min(chunk, budget - off))

    # --- bookkeeping (same contract as ShmObjectStore) ---
    def on_sealed(self, object_id: ObjectID, size: int,
                  grace: bool = False) -> None:
        with self._lock:
            self._sealed[object_id] = size
            if grace:
                # fresh-arrival grace (transfer receives), same
                # rationale as the restore grace: an object pulled FOR
                # a waiting consumer must not be re-spilled before that
                # consumer takes its read lease (observed as a
                # re-pull/re-spill livelock when an over-budget
                # object's only healthy copy is remote and the local
                # backing copy is disk-faulted)
                self._restore_grace[object_id] = time.monotonic() + 2.0
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
        state, _, _ = self.seg.lookup(object_id)
        if state == 2:
            return True
        with self._lock:
            return object_id in self._spilled

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._delete_locked(object_id)

    def _delete_locked(self, object_id: ObjectID) -> None:
        if STORE_DEBUG:
            logger.info("DELETE %s", object_id.hex())
        self._sealed.pop(object_id, None)
        self.seg.delete(object_id)
        spath = self._spilled.pop(object_id, None)
        if spath:
            try:
                os.unlink(spath)
            except FileNotFoundError:
                pass

    def _evict_candidates_locked(self):
        """Spill/evict candidates: segment-indexed sealed objects (the
        segment is the source of truth — workers create/seal without
        notifying this authority) that are neither pinned, reader-held,
        nor inside the restore-grace window. Notified objects (_sealed,
        transfer receives) come first in their LRU order."""
        now = time.monotonic()
        for oid in [o for o, t in self._restore_grace.items()
                    if t < now]:
            del self._restore_grace[oid]
        skip = self._restore_grace
        listed = self.seg.list_sealed()
        refcnt_of = {oid: rc for oid, _sz, rc in listed}
        seen = set(self._sealed.keys())
        # reader-held extents are unspillable (seg.evict would refuse
        # AFTER the disk write): filter by refcount everywhere
        out = [oid for oid in self._sealed.keys()
               if oid not in self._pinned and oid not in skip
               and refcnt_of.get(oid, 0) == 0]
        out += [oid for oid, _sz, rc in listed
                if rc == 0 and oid not in self._pinned
                and oid not in skip and oid not in seen]
        return out

    def maybe_evict(self) -> None:
        """Background spill/eviction toward the nominal budget (called
        from the node heartbeat): keeps resident bytes near capacity so
        foreground creates almost never stall on make_room."""
        with self._lock:
            self._maybe_evict_locked()

    def make_room(self, bytes_needed: int) -> int:
        """Spill/evict LRU unpinned sealed objects until at least
        ``bytes_needed`` of segment DATA capacity is free (or nothing
        more can move). The worker-side create retries after this — the
        reference's create-request-queue semantics
        (plasma/create_request_queue.h), server-authoritative."""
        freed = 0
        with self._lock:
            # bounded per call: spilling is disk I/O under the store
            # lock, and a concurrent restore RPC waiting on this lock
            # must not starve past its caller's deadline — callers loop
            # (runtime create retry), so partial progress is fine
            moved = 0
            for oid in self._evict_candidates_locked():
                # free space measured against the DATA area (ns_stats
                # capacity), not the mapped size (which counts header/
                # slot-table overhead as if it were allocatable)
                used, cap, _ = self.seg.stats()
                if cap - used >= bytes_needed or moved >= 8:
                    break
                before = used
                if self.spill_dir:
                    self._spill_locked(oid)
                elif self.seg.evict(oid) > 0:
                    self._sealed.pop(oid, None)
                moved += 1
                after, _, _ = self.seg.stats()
                freed += max(0, before - after)
            # Fragmentation defense: enough total bytes can be free with
            # no CONTIGUOUS run large enough (pinned extents scattered
            # across the arena) — compact the movable extents before the
            # caller's create retries (observed: 17 MB creates failing
            # at 25% utilization of a 192 MB arena)
            used, cap, _ = self.seg.stats()
            if cap - used >= bytes_needed and \
                    self.seg.largest_free() < bytes_needed:
                self.seg.compact()
        return freed

    def _maybe_evict_locked(self) -> None:
        # Evict against the NOMINAL capacity; the physical segment has
        # headroom so in-flight creates don't fail while we catch up.
        used, _, _ = self.seg.stats()
        if used <= self.capacity:
            return
        moved = 0
        for oid in self._evict_candidates_locked():
            used, _, _ = self.seg.stats()
            if used <= self.capacity * 0.8 or moved >= 8:
                # bounded sweep: the heartbeat calls again next tick;
                # unbounded spilling would hold the lock through many
                # seconds of disk writes and stall restore RPCs
                break
            if self.spill_dir:
                self._spill_locked(oid)
            elif self.seg.evict(oid) > 0:
                self._sealed.pop(oid, None)
            moved += 1

    def _spill_locked(self, object_id: ObjectID) -> None:
        state, off, size = self.seg.lookup(object_id)
        if state != 2:
            return
        dst = os.path.join(self.spill_dir, object_id.hex())
        already = self._spilled.get(object_id)
        if already is None:
            # don't rewrite an existing backing copy: the object can be
            # in BOTH places when a duplicate execution (at-least-once
            # resubmit) re-created an already-spilled object's extent
            try:
                if self._disk_chaos is not None:
                    kind = self._disk_chaos.fault("spill_write")
                    if kind == "enospc":
                        raise OSError(errno.ENOSPC,
                                      "injected spill ENOSPC")
                    if kind is not None:
                        raise OSError(errno.EIO, "injected spill EIO")
                with open(dst, "wb") as f:
                    f.write(self.seg.view[off:off + size])
            except OSError as e:
                # the disk refused the spill (EIO/ENOSPC, injected or
                # real): the extent is still the only copy — keep it
                # resident, drop the partial file, and let a later
                # sweep retry. Pressure degrades to no-progress here
                # instead of data loss.
                try:
                    os.unlink(dst)
                except OSError:
                    pass
                logger.warning("spill of %s failed (%s); keeping the "
                               "object resident", object_id.hex()[:12], e)
                return
        if self.seg.evict(object_id) == 0:
            # A live reader holds the extent; leave it resident. Only
            # remove the file WE just wrote — unlinking a pre-existing
            # backing copy here would strand _spilled pointing at
            # nothing (observed as ObjectLost under spill pressure).
            if already is None:
                try:
                    os.unlink(dst)
                except FileNotFoundError:
                    pass
            return
        self._sealed.pop(object_id, None)
        self._spilled[object_id] = dst
        if STORE_DEBUG:
            logger.info("SPILL %s", object_id.hex())

    def _lease_for_locked(self, object_id: ObjectID,
                          for_pid: Optional[int]) -> None:
        """Take a reader lease ON BEHALF OF the requesting pid before
        the restore RPC reply leaves this process. Closes the
        restore-vs-respill race outright: the extent cannot be spilled
        or evicted again until the requester maps it and releases (the
        grace window only narrowed the race; under sustained spill
        thrash the reply could arrive after the object was re-spilled
        and the get would eventually give up). Leases of crashed
        requesters are reclaimed by reap_dead_readers. Reference:
        ``src/ray/raylet/local_object_manager.h:41`` — spilled objects
        are pinned through the restore handshake."""
        if for_pid:
            self.seg.acquire_for(object_id, int(for_pid))

    def _local_copy_lost_locked(self, object_id: ObjectID,
                                spath: str) -> str:
        """The backing copy is unusable (persistent EIO / truncation):
        forget it so location lookups stop routing here — the caller
        reports the stale holder and the controller re-pulls from
        another holder or reconstructs via lineage. Only after THOSE
        fail does anything surface ObjectLostError."""
        self._restore_strikes.pop(object_id, None)
        self._spilled.pop(object_id, None)
        try:
            os.unlink(spath)
        except OSError:
            pass
        return "lost"

    def maybe_restore(self, object_id: ObjectID,
                      for_pid: Optional[int] = None) -> bool:
        """True = resident (restored or already there); "retry" =
        transient pressure/fault, ask again; "lost" = the local backing
        copy is gone for good (re-pull from another holder); False =
        this node never had it."""
        with self._lock:
            spath = self._spilled.get(object_id)
            if spath is None:
                state, _, _ = self.seg.lookup(object_id)
                if state != 2 and STORE_DEBUG:
                    logger.warning(
                        "RESTOREMISS %s state=%s nspilled=%d",
                        object_id.hex(), state, len(self._spilled))
                if state == 2:
                    self._lease_for_locked(object_id, for_pid)
                    return True
                return False
            if self.seg.lookup(object_id)[0] == 2:
                # resident AND spilled (duplicate-execution re-create):
                # the extent is current; keep the disk copy as backup
                self._lease_for_locked(object_id, for_pid)
                return True
            try:
                size = os.stat(spath).st_size
            except FileNotFoundError:
                # backing file vanished (historical unlink bug, manual
                # cleanup): surface not-restorable instead of raising
                self._spilled.pop(object_id, None)
                return False
            off = self.seg.alloc(object_id, size)
            if off == _FULL:
                # fragmentation first: compaction is cheaper than
                # spilling and may already open a large-enough run
                self.seg.compact()
                off = self.seg.alloc(object_id, size)
            if off == _FULL:
                # Make room by SPILLING other unreferenced residents
                # (never plain eviction here — an unspilled resident's
                # only copy may live in this segment), then retry.
                for other in self._evict_candidates_locked():
                    if other == object_id:
                        continue
                    if self.spill_dir:
                        self._spill_locked(other)
                    elif self.seg.evict(other) > 0:
                        self._sealed.pop(other, None)
                    off = self.seg.alloc(object_id, size)
                    if off != _FULL:
                        break
            if off == _EXISTS:
                # duplicate execution re-created the extent while we
                # looked at the spill index: it is resident — and the
                # handshake lease must STILL be taken (the node reports
                # leased=True on every ok reply; an unbalanced release
                # would zero the requester's own reader ref and let
                # compaction move the extent under its live view)
                self._lease_for_locked(object_id, for_pid)
                return True
            if off == _FULL:
                # the backing copy EXISTS but the segment can't admit it
                # right now (remaining extents reader-held or in their
                # restore grace): transient — callers must retry, not
                # declare the object lost
                return "retry"
            try:
                with open(spath, "rb") as f:
                    n_read = f.readinto(self.seg.view[off:off + size])
                if self._disk_chaos is not None:
                    kind = self._disk_chaos.fault("restore_read")
                    if kind == "truncate":
                        n_read = size // 2
                    elif kind is not None:
                        raise OSError(errno.EIO, "injected restore EIO")
            except OSError as e:
                # transient I/O failure: free the half-written extent so
                # a retry can re-alloc, and back off through the caller.
                # A few consecutive strikes declare the copy unusable.
                self.seg.delete(object_id)
                strikes = self._restore_strikes.get(object_id, 0) + 1
                self._restore_strikes[object_id] = strikes
                logger.warning("restore of %s failed (%s), strike %d",
                               object_id.hex()[:12], e, strikes)
                if strikes < 3:
                    return "retry"
                return self._local_copy_lost_locked(object_id, spath)
            if n_read < size:
                # truncated backing file (torn write, disk corruption):
                # retrying cannot heal it — drop the copy immediately
                self.seg.delete(object_id)
                logger.warning(
                    "restore of %s: truncated backing file (%d/%d "
                    "bytes)", object_id.hex()[:12], n_read, size)
                return self._local_copy_lost_locked(object_id, spath)
            self.seg.seal(object_id)
            os.unlink(spath)
            self._restore_strikes.pop(object_id, None)
            self._spilled.pop(object_id, None)
            self._sealed[object_id] = size
            self._restore_grace[object_id] = time.monotonic() + 2.0
            self._lease_for_locked(object_id, for_pid)
            return True

    def reap_dead_readers(self) -> int:
        """Release references held by dead PIDs (crash cleanup;
        plasma's disconnected-client path). Called from the node
        manager's heartbeat."""
        return self.seg.reap()

    def contents(self):
        """[(object_id_binary, size)] of every sealed (incl. spilled)
        object — the node re-announces these to a restarted controller."""
        with self._lock:
            out = [(oid.binary(), sz) for oid, sz in self._sealed.items()]
            out.extend((oid.binary(), 0) for oid in self._spilled)
            return out

    def stats(self) -> dict:
        used, _, n = self.seg.stats()
        with self._lock:
            return {
                "used_bytes": used,
                "capacity_bytes": self.capacity,
                "num_objects": n,
                "num_spilled": len(self._spilled),
                "num_pinned": len(self._pinned),
                "native": True,
            }

    def destroy(self) -> None:
        with self._lock:
            for spath in self._spilled.values():
                try:
                    os.unlink(spath)
                except FileNotFoundError:
                    pass
            self._spilled.clear()
        self.seg.close(unlink=True)


class NativeShmClient:
    """Worker/driver side: zero-copy create/seal/get on the segment.
    API-compatible with ``ShmClient``."""

    def __init__(self, session_name: str, lib=None):
        from ray_tpu_torch import _native
        self.lib = lib or _native.load()
        assert self.lib is not None
        self.session_name = session_name
        self._seg: Optional[_Segment] = None
        self._acquired: Dict[ObjectID, int] = {}
        self._lock = threading.Lock()
        #: extents this client already madvise-populated. Recycled
        #: extents come back at the same (off, size) with their pages
        #: resident AND present in our page table, so the syscall
        #: (~0.6ms per 64MB: a PTE walk over 16k pages) is pure waste
        #: on every put after the first. Bounded LRU-ish set.
        self._populated: "OrderedDict[tuple, None]" = OrderedDict()

    def _segment(self, timeout: float = 10.0) -> _Segment:
        with self._lock:
            if self._seg is None:
                deadline = time.monotonic() + timeout
                while True:
                    try:
                        self._seg = _Segment(self.lib, self.session_name)
                        break
                    except OSError:
                        if time.monotonic() >= deadline:
                            raise
                        time.sleep(0.01)
            return self._seg

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        seg = self._segment()
        off = seg.alloc(object_id, size)
        if off == _EXISTS:
            raise FileExistsError(object_id.hex())
        if off == _FULL:
            raise ObjectStoreFullError(
                f"native store full creating {object_id.hex()} "
                f"({size} bytes)")
        size = max(size, 1)
        if size >= 1 << 20:
            # prefault large extents so the serializer's memcpy doesn't
            # eat a page trap per 4 KiB (plasma gets this for free from
            # dlmalloc recycling; our recycled extents do too — this
            # covers first-touch). Skipped when WE already populated
            # this exact extent (hot put loops recycle one extent).
            key = (off, size)
            self._populate_once(seg, off, size, write=True)
        return seg.view[off:off + size]

    def _populate_once(self, seg: _Segment, off: int, size: int,
                       write: bool) -> None:
        key = (off, size)
        if key not in self._populated:
            _populate(seg, off, size, write=write)
            self._populated[key] = None
            while len(self._populated) > 1024:
                self._populated.popitem(last=False)

    def seal(self, object_id: ObjectID) -> int:
        size = self._segment().seal(object_id)
        return 0 if size == _FULL else size

    def put_bytes(self, object_id: ObjectID, data) -> int:
        view = self.create(object_id, len(data))
        view[: len(data)] = data
        return self.seal(object_id)

    def get_view(self, object_id: ObjectID,
                 timeout: float = 0.0) -> Optional[memoryview]:
        """Zero-copy view; takes a read reference so the extent cannot
        be reused under us. Balanced by release()/close(); references
        of crashed processes are reaped by the node manager."""
        seg = self._segment()
        deadline = time.monotonic() + timeout
        while True:
            state, off, size = seg.acquire(object_id)
            if state == 2:
                with self._lock:
                    self._acquired[object_id] = \
                        self._acquired.get(object_id, 0) + 1
                if size >= 1 << 20:
                    # a reader's first touch traps per page as a
                    # writer's does
                    self._populate_once(seg, off, size, write=False)
                return seg.view[off:off + size]
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.001)

    def contains(self, object_id: ObjectID) -> bool:
        state, _, _ = self._segment().lookup(object_id)
        return state == 2

    def evict(self, object_id: ObjectID) -> int:
        """Free the extent now if (and only if) no reader holds it.
        Returns freed bytes, 0 if skipped. Owner-side eager recycling:
        freed extents go back on the allocator freelist with their tmpfs
        pages still resident, so the next same-sized create skips the
        page-population cost entirely."""
        return self._segment().evict(object_id)

    def release(self, object_id: ObjectID) -> None:
        with self._lock:
            n = self._acquired.get(object_id, 0)
            if n <= 0 or self._seg is None:
                return
            if n == 1:
                self._acquired.pop(object_id, None)
            else:
                self._acquired[object_id] = n - 1
        self._seg.release(object_id)

    def close(self) -> None:
        with self._lock:
            if self._seg is not None:
                self._seg.release_all()
                self._acquired.clear()
                self._seg.close()
                self._seg = None
