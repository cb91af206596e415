"""Task and actor specifications — the unit of scheduling.

Equivalent of the reference's ``TaskSpecification``
(``src/ray/common/task/task_spec.h``) minus protobuf: a plain dataclass
carried over the control plane. Functions/classes are NOT embedded; they are
exported once to the controller's function store keyed by a
``FunctionDescriptor`` (reference: ``python/ray/_private/function_manager.py``)
and loaded lazily (and cached) by workers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)


#: ``num_returns`` sentinel for streaming generator tasks (the API-level
#: ``num_returns="streaming"``): return objects are minted dynamically,
#: one per yielded item, and reported via STREAM_ITEM while the task
#: runs (reference: TaskSpec returns_dynamically / num_streaming_returns)
STREAMING_RETURNS = -1


@dataclass(frozen=True, slots=True)
class FunctionDescriptor:
    """Stable key for a remote function / actor class."""
    module: str
    qualname: str
    function_hash: str  # sha1 of the pickled function

    def key(self) -> str:
        return f"{self.module}.{self.qualname}:{self.function_hash}"

    def __repr__(self):
        return f"Fn({self.module}.{self.qualname})"

    def __reduce__(self):
        # positional wire form: dataclass pickling writes every field
        # NAME per message; specs ride the per-task hot path, so the
        # names are pure overhead (reference keeps specs in protobuf
        # for the same reason)
        return (FunctionDescriptor,
                (self.module, self.qualname, self.function_hash))


@dataclass(slots=True)
class SchedulingStrategy:
    """Union of the reference's scheduling strategies
    (python/ray/util/scheduling_strategies.py)."""
    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP | NODE_LABEL
    node_id: Optional[NodeID] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
    hard_labels: Dict[str, List[str]] = field(default_factory=dict)
    soft_labels: Dict[str, List[str]] = field(default_factory=dict)

    def __reduce__(self):
        # DEFAULT strategy (the overwhelmingly common case) pickles as a
        # zero-arg call; everything else rides positionally
        if self.kind == "DEFAULT" and self.node_id is None \
                and not self.hard_labels and not self.soft_labels \
                and self.placement_group_id is None:
            return (SchedulingStrategy, ())
        return (SchedulingStrategy, (
            self.kind, self.node_id, self.soft, self.placement_group_id,
            self.placement_group_bundle_index,
            self.placement_group_capture_child_tasks,
            self.hard_labels, self.soft_labels))


@dataclass(slots=True)
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    function: FunctionDescriptor
    # Serialized args blob (SerializedObject wire bytes); refs are passed
    # positionally via arg_refs and substituted at execution time.
    args_blob: bytes = b""
    arg_refs: List[Tuple[int, ObjectID]] = field(default_factory=list)
    num_returns: int = 1
    #: owner-known metadata for arg objects (inline blob / location),
    #: attached at submission so the controller can satisfy dependencies
    #: it never heard about (producer died with TASK_DONE unflushed; the
    #: owner still got its direct TASK_RESULT)
    arg_metas: Optional[Dict[bytes, dict]] = None
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 3
    retry_exceptions: bool = False
    owner: Optional[WorkerID] = None
    name: str = ""
    runtime_env: Optional[dict] = None
    # actor task fields
    actor_id: Optional[ActorID] = None
    sequence_number: int = -1
    concurrency_group: str = ""
    # actor creation fields
    is_actor_creation: bool = False
    #: Reference semantics: by default an actor needs 1 CPU to *schedule*
    #: but holds 0 while alive (python/ray/actor.py default num_cpus); only
    #: explicitly requested resources (GPU, custom) are held for life.
    hold_resources: bool = True
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    actor_name: str = ""
    namespace: str = ""
    is_async_actor: bool = False
    #: streaming-only: per-call backpressure window override
    #: (0 = use config.generator_backpressure_num_objects; <0 = off)
    backpressure: int = 0
    #: causal trace propagation (core/events.py): ``(trace_id,
    #: parent_span)`` hex pair stamped at submission; the task's own
    #: span id is derived from its task id. Rides every spec-carrying
    #: control message (DSP/ASG/ACL/CAC) so the flight recorder links
    #: parent -> child across processes.
    trace: Optional[Tuple[str, Optional[str]]] = None

    @property
    def is_actor_task(self) -> bool:
        return self.actor_id is not None and not self.is_actor_creation

    @property
    def is_streaming(self) -> bool:
        return self.num_returns == STREAMING_RETURNS

    def return_ids(self) -> List[ObjectID]:
        # streaming tasks (num_returns == STREAMING_RETURNS == -1) have
        # no static returns: the empty range is load-bearing
        return [ObjectID.for_task_return(self.task_id, i + 1)
                for i in range(self.num_returns)]

    def __reduce__(self):
        # Positional wire form (same rationale as FunctionDescriptor):
        # a spec crosses at least two process boundaries per task, and
        # dataclass pickling ships all ~25 field names each time —
        # ~3x the bytes and ~3x the CPU of this tuple.
        return (_spec_from_wire, (
            self.task_id, self.job_id, self.function, self.args_blob,
            self.arg_refs, self.num_returns, self.arg_metas,
            self.resources, self.scheduling_strategy, self.max_retries,
            self.retry_exceptions, self.owner, self.name,
            self.runtime_env, self.actor_id, self.sequence_number,
            self.concurrency_group, self.is_actor_creation,
            self.hold_resources, self.max_restarts,
            self.max_task_retries, self.max_concurrency,
            self.max_pending_calls, self.actor_name, self.namespace,
            self.is_async_actor, self.backpressure, self.trace))


def _spec_from_wire(*fields) -> "TaskSpec":
    return TaskSpec(*fields)


@dataclass
class Bundle:
    """A placement-group bundle: an atomic resource reservation
    (reference: src/ray/common/bundle_spec.h)."""
    resources: Dict[str, float]
    node_id: Optional[NodeID] = None  # filled after placement


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    #: PACK | SPREAD | STRICT_PACK | STRICT_SPREAD, plus the TPU gang
    #: pair SLICE_PACK | SLICE_SPREAD (all bundles on hosts of ONE
    #: slice; SPREAD = one bundle per distinct host — see
    #: core/scheduler.py::_plan_slice_bundles)
    strategy: str = "PACK"
    name: str = ""
    creator_job: Optional[JobID] = None


@dataclass
class ActorInfo:
    """Controller-side actor directory entry (reference:
    gcs_actor_manager.h actor state machine :249-281)."""
    actor_id: ActorID
    spec: TaskSpec
    state: str = "PENDING"  # PENDING|STARTING|ALIVE|RESTARTING|DEAD
    node_id: Optional[NodeID] = None
    worker_id: Optional[WorkerID] = None
    num_restarts: int = 0
    name: str = ""
    namespace: str = ""
    death_cause: str = ""
