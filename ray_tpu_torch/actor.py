"""Actors: stateful remote workers.

Equivalent of the reference's ``python/ray/actor.py`` (``ActorClass`` :544,
``_remote`` :830, ``ActorHandle``, ``ActorMethod``). An actor occupies a
dedicated worker process for its lifetime; method calls are ordered
per-caller (the control plane preserves per-peer order); handles are
picklable and usable from any process.
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.core.global_state import global_worker
from ray_tpu_torch.core.ids import ActorID, TaskID
from ray_tpu_torch.core.task_spec import FunctionDescriptor, TaskSpec
from ray_tpu_torch.remote_function import (
    _prepare_env, make_scheduling_strategy, resources_from_opts)

_ACTOR_DEFAULT_OPTS = dict(
    num_cpus=1.0, num_gpus=0.0, resources=None, max_restarts=0,
    max_task_retries=0, max_concurrency=1, max_pending_calls=-1,
    name=None, namespace="", lifetime=None, scheduling_strategy=None,
    runtime_env=None, memory=None, placement_group=None,
    placement_group_bundle_index=-1,
)


def method(**opts):
    """Decorator for per-method options (reference: ray.method)."""
    def deco(fn):
        fn.__ray_tpu_method_opts__ = opts
        return fn
    return deco


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._opts = dict(_ACTOR_DEFAULT_OPTS)
        self._opts.update(options)
        self.__name__ = cls.__name__
        self._pickled: Optional[bytes] = None
        self._descriptor: Optional[FunctionDescriptor] = None
        self._exported_sessions = set()
        self._is_async = any(
            inspect.iscoroutinefunction(v) or inspect.isasyncgenfunction(v)
            for v in vars(cls).values() if callable(v))

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote().")

    def options(self, **overrides) -> "ActorClass":
        ac = ActorClass(self._cls, **{**self._opts, **overrides})
        ac._pickled = self._pickled
        ac._descriptor = self._descriptor
        ac._exported_sessions = self._exported_sessions
        return ac

    def _ensure_exported(self, w) -> FunctionDescriptor:
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._cls)
            h = hashlib.sha1(self._pickled).hexdigest()[:16]
            self._descriptor = FunctionDescriptor(
                module=getattr(self._cls, "__module__", "") or "",
                qualname=self._cls.__qualname__, function_hash=h)
        key = self._descriptor.key()
        sid = w.worker_id.binary()  # not id(w): see RemoteFunction
        if sid not in self._exported_sessions:
            w.export_function(key, self._pickled)
            self._exported_sessions.add(sid)
        return self._descriptor

    def remote(self, *args, **kwargs) -> "ActorHandle":
        opts = self._opts
        from ray_tpu_torch.remote_function import _client_route
        client = _client_route()
        if client is not None:
            if getattr(self, "_client_cls", None) is None:
                self._client_cls = client._wrap(
                    self._cls,
                    {k: v for k, v in opts.items() if v is not None})
            return self._client_cls.remote(*args, **kwargs)
        # default-resource actors release their scheduling CPU once alive
        hold = any(opts.get(k) not in (None, _ACTOR_DEFAULT_OPTS.get(k))
                   for k in ("num_cpus", "num_gpus", "resources", "memory"))
        w = global_worker()
        descriptor = self._ensure_exported(w)
        actor_id = ActorID.of(w.job_id)
        args_blob, arg_refs, _ = w.serialize_args(args, kwargs)
        max_concurrency = opts["max_concurrency"]
        if self._is_async and max_concurrency == 1:
            max_concurrency = 1000  # reference default for async actors
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(actor_id),
            job_id=w.job_id,
            function=descriptor,
            args_blob=args_blob,
            arg_refs=[(i, oid) for i, oid in arg_refs],
            num_returns=1,
            resources=resources_from_opts(opts),
            scheduling_strategy=make_scheduling_strategy(opts),
            is_actor_creation=True,
            hold_resources=hold,
            actor_id=actor_id,
            max_restarts=opts["max_restarts"],
            max_task_retries=opts["max_task_retries"],
            max_concurrency=max_concurrency,
            max_pending_calls=opts["max_pending_calls"],
            actor_name=opts.get("name") or "",
            namespace=opts.get("namespace") or "",
            is_async_actor=self._is_async,
            name=f"{self.__name__}.__init__",
            runtime_env=_prepare_env(w, opts.get("runtime_env")),
        )
        w.create_actor(spec)
        return ActorHandle(actor_id, self.__name__,
                           max_task_retries=opts["max_task_retries"])

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassNode
        return ClassNode(self, args, kwargs)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns=1,
                 backpressure: int = 0):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._backpressure = backpressure

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(self._handle, self._name,
                        opts.get("num_returns", self._num_returns),
                        int(opts.get("generator_backpressure_num_objects")
                            or self._backpressure))
        return m

    def remote(self, *args, **kwargs):
        return self._handle._submit_method(
            self._name, args, kwargs, self._num_returns,
            self._backpressure)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "",
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        self._seq = 0

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_") and not name.startswith("__ray"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def _submit_method(self, name: str, args, kwargs, num_returns,
                       backpressure: int = 0):
        w = global_worker()
        args_blob, arg_refs, _ = w.serialize_args(args, kwargs)
        self._seq += 1
        from ray_tpu_torch.core.task_spec import STREAMING_RETURNS
        streaming = num_returns == "streaming"
        spec = TaskSpec(
            task_id=TaskID.for_actor_task(self._actor_id),
            job_id=w.job_id,
            function=FunctionDescriptor("", name, ""),
            args_blob=args_blob,
            arg_refs=[(i, oid) for i, oid in arg_refs],
            num_returns=STREAMING_RETURNS if streaming else num_returns,
            actor_id=self._actor_id,
            sequence_number=self._seq,
            max_retries=self._max_task_retries,
            name=f"{self._class_name}.{name}",
            backpressure=backpressure,
        )
        if streaming:
            return w.submit_streaming_task(spec)
        refs = w.submit_task(spec)
        return refs[0] if num_returns == 1 else refs

    def __ray_ready__(self):
        return self._submit_method("__ray_ready__", (), {}, 1)

    def __reduce__(self):
        return (_rebuild_handle,
                (self._actor_id.binary(), self._class_name,
                 self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


def _rebuild_handle(actor_id_b: bytes, class_name: str, max_task_retries: int):
    return ActorHandle(ActorID(actor_id_b), class_name, max_task_retries)
