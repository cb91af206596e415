"""Binary identifiers for all framework entities.

Modeled on the reference ID scheme (``src/ray/common/id.h`` and
``src/ray/design_docs/id_specification.md``): IDs are fixed-width byte
strings with structural nesting — an ObjectID embeds the TaskID of the task
that created it, a TaskID embeds the ActorID (or a nil actor) and the JobID —
so ownership and lineage can be derived from the ID itself without a lookup.

Sizes (bytes):
    JobID 4, ActorID 16 (= JobID + 12 unique), TaskID 24 (= ActorID + 8
    unique), ObjectID 28 (= TaskID + 4 LE return-index), NodeID 28,
    WorkerID 28, PlacementGroupID 18 (= JobID + 14 unique).
"""

from __future__ import annotations

import os
import random
import threading

# /dev/urandom syscalls cost ~100us in sandboxed environments; ID minting is
# on the task-submission hot path, so draw from a process-local PRNG seeded
# once from the OS (fork-safe: reseeded per pid).
_rng_state = threading.local()


def _rand_bytes(n: int) -> bytes:
    st = getattr(_rng_state, "v", None)
    if st is None or st[0] != os.getpid():
        st = (os.getpid(), random.Random(os.urandom(32)))
        _rng_state.v = st
    return st[1].getrandbits(n * 8).to_bytes(n, "little")

JOB_ID_SIZE = 4
ACTOR_ID_SIZE = 16
TASK_ID_SIZE = 24
OBJECT_ID_SIZE = 28
NODE_ID_SIZE = 28
WORKER_ID_SIZE = 28
PLACEMENT_GROUP_ID_SIZE = 18

_ACTOR_UNIQUE = ACTOR_ID_SIZE - JOB_ID_SIZE
_TASK_UNIQUE = TASK_ID_SIZE - ACTOR_ID_SIZE
_PG_UNIQUE = PLACEMENT_GROUP_ID_SIZE - JOB_ID_SIZE


class BaseID:
    """A fixed-width binary ID. Immutable, hashable, comparable."""

    SIZE = 0
    __slots__ = ("_bytes",)

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got "
                f"{len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        self._bytes = binary

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def __hash__(self):
        return hash(self._bytes)

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE
    __slots__ = ()

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + _rand_bytes(_ACTOR_UNIQUE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE
    __slots__ = ()

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(ActorID.nil().binary()[:ACTOR_ID_SIZE - JOB_ID_SIZE]
                   + job_id.binary() + _rand_bytes(_TASK_UNIQUE))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + _rand_bytes(_TASK_UNIQUE))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        # The driver's implicit "main" task; return-index 0 objects from it
        # are `put()` objects.
        return cls(ActorID.nil().binary()[:ACTOR_ID_SIZE - JOB_ID_SIZE]
                   + job_id.binary() + b"\x00" * _TASK_UNIQUE)

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:ACTOR_ID_SIZE])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE
    __slots__ = ()

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid colliding with
        # return objects (reference: ObjectID::FromIndex semantics).
        return cls(task_id.binary() + (put_index | 0x80000000).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TASK_ID_SIZE:], "little") & 0x7FFFFFFF

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bytes[TASK_ID_SIZE:], "little") & 0x80000000)


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE
    __slots__ = ()


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE
    __slots__ = ()


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + _rand_bytes(_PG_UNIQUE))
