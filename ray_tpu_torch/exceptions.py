"""Error model: exceptions stored as task results and re-raised at ``get``.

The port's copy of ``ray_tpu/exceptions.py`` (the JAX package's error
model, after the reference's ``python/ray/exceptions.py``: RayTaskError
:46, RayActorError, ObjectLostError, TaskCancelledError,
OutOfMemoryError), with the serving engine's errors beside it. A failed
task's result object *is* its exception; ``ray_tpu_torch.get`` re-raises
it on the caller with the remote traceback attached. The port imports
nothing from the JAX package, so it keeps its own copy.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class EngineDeadError(RayTpuError):
    """The engine's step loop died; every queued or in-flight request is
    failed with this, so consumers never hang on a dead engine."""


class RequestTooLargeError(RayTpuError):
    """prompt_len + 1 exceeds the engine's per-request window
    (``max_seq_len``): the request can never be admitted."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Stored as the task's return object; re-raised at ``get`` with the remote
    traceback string (reference: RayTaskError.as_instanceof_cause).
    """

    def __init__(self, function_name: str, traceback_str: str,
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"Task {function_name} failed.\nRemote traceback:\n{traceback_str}"
        )

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, cause=exc)

    def __reduce__(self):
        # cause may not be picklable; degrade to its repr
        cause = self.cause
        try:
            import pickle
            pickle.dumps(cause)
        except Exception:
            cause = None
        return (TaskError, (self.function_name, self.traceback_str, cause))


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor is dead; pending and future calls fail with this.

    Reference: RayActorError / ActorDiedError (python/ray/exceptions.py),
    produced by GcsActorManager death notifications.
    """

    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} died: {reason}")

    def __reduce__(self):
        return (ActorDiedError, (self.actor_id, self.reason))


class ActorUnavailableError(ActorError):
    """Actor temporarily unreachable (e.g. restarting).

    Raised for calls that race an actor restart and are not retriable
    (``max_task_retries=0``). Unlike :class:`ActorDiedError` the actor
    may become ALIVE again — callers holding the handle can retry;
    retriable calls are instead queued transparently until the actor
    re-resolves (reference: python/ray/exceptions.py
    ActorUnavailableError semantics).
    """

    def __init__(self, actor_id=None, reason: str = "actor is restarting"):
        self.actor_id = actor_id
        self.reason = reason
        super().__init__(f"Actor {actor_id} unavailable: {reason}")

    def __reduce__(self):
        return (ActorUnavailableError, (self.actor_id, self.reason))


class ObjectLostError(RayTpuError):
    """Object's value was lost and could not be reconstructed via lineage.

    Reference: python/ray/exceptions.py ObjectLostError and the recovery
    path in src/ray/core_worker/object_recovery_manager.h:90.
    """

    def __init__(self, object_ref=None, reason: str = "all copies lost"):
        self.object_ref = object_ref
        self.reason = reason
        super().__init__(f"Object {object_ref} lost: {reason}")

    def __reduce__(self):
        return (ObjectLostError, (self.object_ref, self.reason))


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_ref=None):
        super(ObjectLostError, self).__init__(
            f"Object {object_ref} unrecoverable: owner died")
        self.object_ref = object_ref


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id,))


class OutOfMemoryError(RayTpuError):
    """Raised when the node memory monitor kills a task (reference:
    src/ray/common/memory_monitor.h + worker_killing_policy.h)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get(..., timeout=)`` expired before the object was ready."""


class RpcTimeoutError(RayTpuError, TimeoutError):
    """A control-plane request/reply RPC timed out.

    Carries the wire message type and the elapsed wait so a timeout is
    attributable from the exception alone (reference: gRPC deadline
    exceeded statuses carry the method name). Subclasses TimeoutError so
    pre-existing catch sites keep working.
    """

    def __init__(self, mtype: Optional[bytes] = None,
                 elapsed_s: Optional[float] = None):
        self.mtype = mtype
        self.elapsed_s = elapsed_s
        what = mtype.decode("ascii", "replace") if mtype else "?"
        took = f" after {elapsed_s:.1f}s" if elapsed_s is not None else ""
        super().__init__(
            f"control-plane RPC {what} timed out{took}")

    def __reduce__(self):
        return (RpcTimeoutError, (self.mtype, self.elapsed_s))


class DeliveryFailedError(RayTpuError):
    """The reliable-delivery layer gave up on a one-way control message:
    it was retransmitted to the attempt cap without an ack and the peer
    was never declared dead. Surfaced through the transport's ``on_fail``
    hook / ``failures`` list rather than raised at a call site — one-way
    messages have no waiting caller.
    """

    def __init__(self, mtype: Optional[bytes] = None, target=None,
                 attempts: int = 0, elapsed_s: float = 0.0):
        self.mtype = mtype
        self.target = target
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        what = mtype.decode("ascii", "replace") if mtype else "?"
        peer = target.hex()[:12] if isinstance(target, bytes) else \
            ("controller" if target is None else repr(target))
        super().__init__(
            f"delivery of {what} to {peer} failed after {attempts} "
            f"attempts over {elapsed_s:.1f}s (no ack, no death notice)")

    def __reduce__(self):
        return (DeliveryFailedError,
                (self.mtype, self.target, self.attempts, self.elapsed_s))


class StreamCancelledError(RayTpuError):
    """An ``ObjectRefGenerator`` was iterated after ``close()``/``cancel()``.

    Early consumer termination cancels the producer task and drops the
    stream's buffered item refs; further iteration is a caller bug and
    surfaces as this typed error rather than a hang on items that will
    never arrive.
    """

    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"stream of task {task_id} was cancelled")

    def __reduce__(self):
        return (StreamCancelledError, (self.task_id,))


class AdmissionRejectedError(RayTpuError):
    """SLO-aware admission shed this request at the router before it
    reached a replica queue (``serve/admission.py``): the tenant is
    over its token budget, or the serve fleet is overloaded and the
    request's priority class is below the shed line. Retry later, with
    a higher priority class, or under a different tenant budget — the
    HTTP proxy maps this to 429 Too Many Requests.
    """

    def __init__(self, tenant: str = "default",
                 priority: str = "normal", reason: str = "overload",
                 detail: str = "", request_id: str = ""):
        self.tenant = tenant
        self.priority = priority
        self.reason = reason
        self.detail = detail
        # trace identity of the shed request, when the router minted
        # one — lets 429 bodies and ARBITER_REJECT events be joined
        # against the request-trace store's SHED waterfall
        self.request_id = request_id
        super().__init__(
            f"request shed at admission ({reason}): tenant "
            f"{tenant!r}, priority {priority!r}"
            + (f" — {detail}" if detail else "")
            + (f" [request_id={request_id}]" if request_id else ""))

    def __reduce__(self):
        return (AdmissionRejectedError,
                (self.tenant, self.priority, self.reason, self.detail,
                 self.request_id))


class ObjectStoreFullError(RayTpuError):
    """Shared-memory store is full and eviction/spill could not make room."""


class RuntimeEnvSetupError(RayTpuError):
    """Failed to set up a task/actor runtime environment."""


class PendingCallsLimitExceeded(RayTpuError):
    """Too many in-flight calls to an actor (max_pending_calls)."""
