"""@remote functions.

Equivalent of the reference's ``python/ray/remote_function.py`` (:262
``_remote`` → ``core_worker.submit_task``). The function body is pickled
once and exported to the controller's function store keyed by descriptor
(reference: ``_private/function_manager.py``); submissions carry only the
key.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.core.global_state import global_worker
from ray_tpu_torch.core.ids import TaskID


def _client_route():
    """The installed ray:// ClientWorker iff client mode is active AND
    no local runtime exists (a local runtime always wins)."""
    from ray_tpu_torch.core.global_state import try_global_worker
    if try_global_worker() is not None:
        return None
    from ray_tpu_torch import api
    return api._client_or_none()
from ray_tpu_torch.core.task_spec import FunctionDescriptor, SchedulingStrategy, TaskSpec


def _prepare_env(w, env):
    """Package working_dir/py_modules into the session cache before the
    spec ships (reference: runtime-env agent URI creation)."""
    if not env:
        return env
    from ray_tpu_torch.core.runtime_env import prepare_runtime_env
    return prepare_runtime_env(env, w.session_dir)


_DEFAULT_OPTS = dict(
    num_cpus=1.0, num_gpus=0.0, resources=None, num_returns=1,
    max_retries=3, retry_exceptions=False, name=None,
    scheduling_strategy=None, runtime_env=None, memory=None,
    placement_group=None, placement_group_bundle_index=-1,
    generator_backpressure_num_objects=None,
)


def make_scheduling_strategy(opts: Dict[str, Any]) -> SchedulingStrategy:
    strat = opts.get("scheduling_strategy")
    if isinstance(strat, SchedulingStrategy):
        return strat
    if strat == "SPREAD":
        return SchedulingStrategy(kind="SPREAD")
    if strat == "DEFAULT" or strat is None:
        pg = opts.get("placement_group")
        if pg is not None:
            return SchedulingStrategy(
                kind="PLACEMENT_GROUP", placement_group_id=pg.id,
                placement_group_bundle_index=opts.get(
                    "placement_group_bundle_index", -1))
        return SchedulingStrategy()
    # user objects from ray_tpu_torch.util.scheduling_strategies convert themselves
    if hasattr(strat, "to_internal"):
        return strat.to_internal()
    raise ValueError(f"bad scheduling_strategy: {strat!r}")


def resources_from_opts(opts: Dict[str, Any]) -> Dict[str, float]:
    res = dict(opts.get("resources") or {})
    ncpu = opts.get("num_cpus")
    if ncpu:
        res["CPU"] = float(ncpu)
    ngpu = opts.get("num_gpus")
    if ngpu:
        res["GPU"] = float(ngpu)
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    return res


class RemoteFunction:
    def __init__(self, fn, **options):
        self._function = fn
        self._opts = dict(_DEFAULT_OPTS)
        self._opts.update(options)
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)
        self._pickled: Optional[bytes] = None
        self._descriptor: Optional[FunctionDescriptor] = None
        self._exported_sessions = set()

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote().")

    def options(self, **overrides) -> "RemoteFunction":
        rf = RemoteFunction(self._function, **{**self._opts, **overrides})
        rf._pickled = self._pickled
        rf._descriptor = self._descriptor
        rf._exported_sessions = self._exported_sessions
        return rf

    def _ensure_exported(self, w) -> FunctionDescriptor:
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._function)
            h = hashlib.sha1(self._pickled).hexdigest()[:16]
            self._descriptor = FunctionDescriptor(
                module=getattr(self._function, "__module__", "") or "",
                qualname=getattr(self._function, "__qualname__", self.__name__),
                function_hash=h)
        key = self._descriptor.key()
        # keyed by the runtime's random worker id, not id(w): a runtime
        # collected after shutdown can leave its address to the next
        # one, which would then never receive the export
        sid = w.worker_id.binary()
        if sid not in self._exported_sessions:
            w.export_function(key, self._pickled)
            self._exported_sessions.add(sid)
        return self._descriptor

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._opts)

    def _remote(self, args, kwargs, opts):
        client = _client_route()
        if client is not None:
            # decorated before ray_tpu_torch.init("ray://..."): route
            # through the client at call time (reference: client-mode hooks)
            if getattr(self, "_client_fn", None) is None:
                self._client_fn = client._wrap(
                    self._function,
                    {k: v for k, v in opts.items() if v is not None})
            return self._client_fn.remote(*args, **kwargs)
        w = global_worker()
        descriptor = self._ensure_exported(w)
        args_blob, arg_refs, _ = w.serialize_args(args, kwargs)
        # resources/strategy are pure functions of opts — compute once
        # per opts object, not per call (fan-out submit hot path). The
        # resources dict is copied into each spec (specs outlive the
        # call in _inflight_specs; a shared mutable dict would be a
        # corruption hazard); the strategy instance is shared and
        # treated as a read-only descriptor downstream.
        cache = getattr(self, "_opts_cache", None)
        if cache is None or cache[0] is not opts:
            cache = (opts, resources_from_opts(opts),
                     make_scheduling_strategy(opts))
            self._opts_cache = cache
        num_returns = opts["num_returns"]
        # num_returns="streaming": a generator task — items become their
        # own objects, reported while the task runs; the call returns an
        # ObjectRefGenerator (reference: ray.remote num_returns model)
        streaming = num_returns == "streaming"
        from ray_tpu_torch.core.task_spec import STREAMING_RETURNS
        spec = TaskSpec(
            task_id=w.next_task_id(),
            job_id=w.job_id,
            function=descriptor,
            args_blob=args_blob,
            arg_refs=[(i, oid) for i, oid in arg_refs],
            num_returns=STREAMING_RETURNS if streaming else num_returns,
            resources=dict(cache[1]),
            scheduling_strategy=cache[2],
            max_retries=opts["max_retries"],
            retry_exceptions=bool(opts["retry_exceptions"]),
            name=opts.get("name") or self.__name__,
            runtime_env=_prepare_env(w, opts.get("runtime_env")),
            backpressure=int(
                opts.get("generator_backpressure_num_objects") or 0),
        )
        if streaming:
            return w.submit_streaming_task(spec)
        refs = w.submit_task(spec)
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        """DAG API entry (reference: python/ray/dag/function_node.py)."""
        from ray_tpu_torch.dag import FunctionNode
        return FunctionNode(self, args, kwargs)
