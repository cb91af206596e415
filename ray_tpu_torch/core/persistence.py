"""Controller state persistence: snapshot + write-ahead log.

Reference: the GCS persists its tables through a store client
(``src/ray/gcs/store_client/redis_store_client.h`` — Redis in production,
in-memory otherwise) so ``gcs_server`` restart recovers actors/KV/jobs,
and raylets re-register on reconnect (``node_manager.cc:1114``). Here the
durable store is a length-prefixed pickle WAL in the session directory
(one host owns the controller; a TPU-pod control plane does not need a
Redis dependency), compacted into a snapshot when the log grows.

What is durable: the KV store, exported functions, the named-actor
directory (spec + name), and the job counter. Everything else — node
membership, worker pools, object locations, in-flight tasks — is owned
by processes that outlive the controller and is reconstructed through
the RECONNECT re-announcement protocol, mirroring the reference's
"GCS is recoverable state + resubscribe" design.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.core import protocol as P

_LEN = struct.Struct("<I")


class ControllerStore:
    """Append-only op log with snapshot compaction."""

    def __init__(self, session_dir: str, compact_every: int = 10_000):
        self.dir = os.path.join(session_dir, "controller_state")
        os.makedirs(self.dir, exist_ok=True)
        self.snap_path = os.path.join(self.dir, "snapshot.bin")
        self.wal_path = os.path.join(self.dir, "wal.bin")
        self.compact_every = compact_every
        self._lock = threading.Lock()
        self._ops_since_snap = 0
        self._wal = open(self.wal_path, "ab")

    # ------------------------------------------------------------- write
    def append(self, op: Tuple) -> None:
        blob = P.dumps(op)
        with self._lock:
            self._wal.write(_LEN.pack(len(blob)) + blob)
            self._wal.flush()
            # the ack a client sees after this append must survive power
            # loss, same durability the snapshot path promises
            os.fsync(self._wal.fileno())
            self._ops_since_snap += 1

    def maybe_compact(self, state_fn: Callable[[], dict]) -> None:
        """Replace snapshot+log with a fresh snapshot when the log is
        long. ``state_fn`` must return the full durable state."""
        with self._lock:
            if self._ops_since_snap < self.compact_every:
                return
        self.snapshot(state_fn())

    def snapshot(self, state: dict) -> None:
        tmp = self.snap_path + ".tmp"
        blob = P.dumps(state)
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            self._wal.close()
            self._wal = open(self.wal_path, "wb")  # truncate
            self._ops_since_snap = 0

    # -------------------------------------------------------------- read
    def load(self) -> Tuple[Optional[dict], List[Tuple]]:
        """(snapshot state or None, ops appended since the snapshot).
        A torn trailing WAL record (crash mid-append) is dropped."""
        snap = None
        if os.path.exists(self.snap_path):
            try:
                with open(self.snap_path, "rb") as f:
                    snap = P.loads(f.read())
            except Exception:
                snap = None
        ops: List[Tuple] = []
        try:
            with open(self.wal_path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raw = b""
        off = 0
        while off + _LEN.size <= len(raw):
            (n,) = _LEN.unpack_from(raw, off)
            if off + _LEN.size + n > len(raw):
                break  # torn tail
            try:
                ops.append(P.loads(raw[off + _LEN.size:off + _LEN.size + n]))
            except Exception:
                break
            off += _LEN.size + n
        return snap, ops

    def close(self) -> None:
        with self._lock:
            try:
                self._wal.close()
            except Exception:
                pass
