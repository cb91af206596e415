"""ObjectRef: a future-like distributed reference to an immutable object.

Equivalent of the reference's ``ObjectRef`` (``python/ray/includes/
object_ref.pxi``): hashable, awaitable, picklable. Pickling a ref inside
another object triggers the *borrowing* protocol (reference:
``src/ray/core_worker/reference_count.h:61``): the serializer records the
contained ref, and the deserializing process registers itself as a borrower
with the owner so the object is not freed while borrowed.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.ids import ObjectID, WorkerID


class ObjectRef:
    __slots__ = ("_id", "_owner", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[WorkerID] = None,
                 _register: bool = True):
        self._id = object_id
        self._owner = owner
        self._registered = False
        if _register:
            ctx = _get_refcount_context()
            if ctx is not None:
                ctx.add_local_reference(self)
                self._registered = True

    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner(self) -> Optional[WorkerID]:
        return self._owner

    def task_id(self):
        return self._id.task_id()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()[:16]})"

    def __del__(self):
        if self._registered:
            try:
                ctx = _get_refcount_context()
                if ctx is not None:
                    ctx.remove_local_reference(self)
            except Exception:
                pass

    def __reduce__(self):
        # Custom reducer: route through the serialization context so
        # contained refs are recorded for borrowing. Direct pickling (outside
        # a SerializationContext) reconstructs a non-registered ref.
        from ray_tpu_torch.core import serialization
        ctx = serialization.get_active_context()
        if ctx is not None:
            ctx.record_contained_ref(self)
        # any serialization means the ref may leave this process — the
        # owner loses the right to eagerly free the object
        from ray_tpu_torch.core.global_state import try_global_worker
        w = try_global_worker()
        if w is not None:
            w.mark_ref_escaped(self._id.binary())
        return (_deserialize_ref, (self._id.binary(), self._owner.binary() if self._owner else None))

    def __await__(self):
        return self.as_future().__await__()

    def as_future(self):
        import asyncio
        from ray_tpu_torch.core.global_state import global_worker
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        w = global_worker()

        def _done(value, err):
            def _set():
                if fut.cancelled():
                    return
                if err is not None:
                    fut.set_exception(err)
                else:
                    fut.set_result(value)
            loop.call_soon_threadsafe(_set)

        w.register_completion_callback(self, _done)
        return fut

    def future(self):
        """concurrent.futures.Future view (reference: ObjectRef.future())."""
        import concurrent.futures
        from ray_tpu_torch.core.global_state import global_worker
        fut = concurrent.futures.Future()
        w = global_worker()

        def _done(value, err):
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(value)

        w.register_completion_callback(self, _done)
        return fut


def _deserialize_ref(id_binary: bytes, owner_binary):
    from ray_tpu_torch.core import serialization
    owner = WorkerID(owner_binary) if owner_binary else None
    ref = ObjectRef(ObjectID(id_binary), owner)
    ctx = serialization.get_active_context()
    if ctx is not None:
        ctx.record_deserialized_ref(ref)
    return ref


def _get_refcount_context():
    from ray_tpu_torch.core.global_state import try_global_worker
    w = try_global_worker()
    if w is None:
        return None
    return w.reference_counter
