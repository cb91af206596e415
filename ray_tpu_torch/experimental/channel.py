"""Mutable-object channels: zero-RPC shared-memory hand-off.

Reference: ``python/ray/experimental/channel.py:49`` (Channel over a
mutable plasma object) + ``src/ray/core_worker/
experimental_mutable_object_manager.h:63`` (seqno'd header, writer
blocks until readers release). The reference re-seals a special plasma
object per version; here the channel is its own mmapped file with an
inline header — one writer and a fixed set of readers synchronize
through aligned 8-byte fields (atomic loads/stores on every platform
CPython runs on) with adaptive spin-then-sleep waits instead of
cross-process semaphores, so a hand-off costs microseconds and no
control-plane message at all.

Layout (little-endian u64 fields, 4 KiB header):
  [0]  magic
  [1]  capacity (payload bytes)
  [2]  num_readers
  [3]  seqno          - version currently published (0 = nothing yet)
  [4]  payload_size   - bytes valid for this seqno; CLOSED sentinel ends
  [5..] reader acks   - reader i stores the seqno it finished consuming

Writer protocol: wait until every ack == seqno (previous value fully
consumed), memcpy payload, then publish seqno+1. Reader protocol: wait
until seqno > last consumed, read, store ack. Single-slot with
back-pressure, exactly the reference's semantics.

A value is pickled with the object store's tensor hook
(``core/serialization.py``): a tensor, on whatever device, crosses as
its dtype, shape and bytes and is read back as a CPU tensor, as ``get``
gives it.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
import uuid
from typing import Any, Optional

from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core.serialization import pickle_inband

_MAGIC = 0x52545055_4348414E  # "RTPUCHAN"
_HEADER = 4096
_CLOSED = 2 ** 64 - 1
_MAX_READERS = (_HEADER - 40) // 8
_U64 = struct.Struct("<Q")


class ChannelClosed(Exception):
    """The writer closed the channel."""


def _wait(predicate, timeout: Optional[float], what: str):
    """Adaptive spin: hot for 200 polls, then escalate to short sleeps.
    Each hot poll yields the GIL: a peer in this process (a reader or
    writer thread) then runs at once instead of after the next 50th
    poll, which doubles a cross-thread hand-off's rate, and more than
    that on a loaded host."""
    deadline = None if timeout is None else time.monotonic() + timeout
    spins = 0
    while True:
        if predicate():
            return
        spins += 1
        if spins < 200:
            time.sleep(0)  # yield the GIL: the peer may be in-process
            continue
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"channel {what} timed out")
        time.sleep(0.000_05 if spins < 2000 else 0.001)


class _Mapped:
    def __init__(self, path: str, capacity: Optional[int]):
        self.path = path
        if capacity is not None:
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
            try:
                os.ftruncate(fd, _HEADER + capacity)
                self.mm = mmap.mmap(fd, _HEADER + capacity)
            finally:
                os.close(fd)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                total = os.fstat(fd).st_size
                self.mm = mmap.mmap(fd, total)
            finally:
                os.close(fd)

    def get(self, idx: int) -> int:
        return _U64.unpack_from(self.mm, idx * 8)[0]

    def put(self, idx: int, value: int) -> None:
        _U64.pack_into(self.mm, idx * 8, value)

    def close(self) -> None:
        try:
            self.mm.close()
        except Exception:
            pass


class Channel:
    """Writer end (also the creator). Picklable: unpickling yields a
    writer handle onto the same channel."""

    def __init__(self, capacity: int = 1 << 20, num_readers: int = 1,
                 _path: Optional[str] = None):
        if num_readers < 1 or num_readers > _MAX_READERS:
            raise ValueError(f"num_readers must be 1..{_MAX_READERS}")
        self.capacity = capacity
        self.num_readers = num_readers
        if _path is None:
            self.path = f"/dev/shm/raytorch-chan-{uuid.uuid4().hex[:16]}"
            self._m = _Mapped(self.path, capacity)
            self._m.put(1, capacity)
            self._m.put(2, num_readers)
            self._m.put(0, _MAGIC)  # publish last
        else:
            self.path = _path
            self._m = _Mapped(self.path, None)
            if self._m.get(0) != _MAGIC:
                raise ValueError(f"not a channel: {self.path}")

    # ------------------------------------------------------------ write
    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        # tensors through the object store's hook: a reader gets what
        # ``get`` would give (a CPU tensor of the same bits), never a
        # CUDA tensor rebuilt on its own device
        blob = pickle_inband(value)
        if len(blob) > self.capacity:
            raise ValueError(
                f"serialized value ({len(blob)} B) exceeds channel "
                f"capacity ({self.capacity} B)")
        self._write_raw(blob, len(blob), timeout)

    def _write_raw(self, blob: bytes, size: int,
                   timeout: Optional[float]) -> None:
        m = self._m
        seq = m.get(3)
        n = self.num_readers
        _wait(lambda: all(m.get(5 + i) >= seq for i in range(n)),
              timeout, "write (readers lagging)")
        if blob:
            m.mm[_HEADER:_HEADER + len(blob)] = blob
        m.put(4, size)
        m.put(3, seq + 1)

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Publish the CLOSED sentinel (readers raise ChannelClosed).
        Raises TimeoutError when a lagging reader never drains the last
        value — swallowing that would leave readers blocked forever with
        the caller believing the channel closed."""
        self._write_raw(b"", _CLOSED, timeout)

    def reader(self, reader_id: int = 0) -> "ReaderHandle":
        return ReaderHandle(self.path, reader_id)

    def destroy(self) -> None:
        self._m.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def __reduce__(self):
        return (_open_writer, (self.path,))


def _open_writer(path: str) -> Channel:
    ch = Channel.__new__(Channel)
    ch.path = path
    ch._m = _Mapped(path, None)
    if ch._m.get(0) != _MAGIC:
        raise ValueError(f"not a channel: {path}")
    ch.capacity = ch._m.get(1)
    ch.num_readers = ch._m.get(2)
    return ch


class ReaderHandle:
    """Reader end: each reader owns ack slot ``reader_id``. Picklable —
    ship it to the consuming actor/task."""

    def __init__(self, path: str, reader_id: int):
        self.path = path
        self.reader_id = reader_id
        self._m: Optional[_Mapped] = None
        self._last = 0

    def _map(self) -> _Mapped:
        if self._m is None:
            self._m = _Mapped(self.path, None)
            if self._m.get(0) != _MAGIC:
                raise ValueError(f"not a channel: {self.path}")
            # resume from our persisted ack (reader restarted)
            self._last = self._m.get(5 + self.reader_id)
        return self._m

    def read(self, timeout: Optional[float] = None) -> Any:
        m = self._map()
        _wait(lambda: m.get(3) > self._last, timeout, "read")
        size = m.get(4)
        if size == _CLOSED:
            raise ChannelClosed
        value = P.loads(bytes(m.mm[_HEADER:_HEADER + size]))
        self._last = m.get(3)
        m.put(5 + self.reader_id, self._last)
        return value

    def close(self) -> None:
        if self._m is not None:
            self._m.close()
            self._m = None

    def __reduce__(self):
        return (ReaderHandle, (self.path, self.reader_id))
