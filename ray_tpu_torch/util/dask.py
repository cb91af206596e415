"""Dask-on-ray_tpu_torch scheduler shim (reference: ``python/ray/util/dask/``
— ``ray_dask_get``, a dask scheduler that runs each task in the dask
graph as a Ray task, with ObjectRefs flowing between them).

Usage::

    import dask
    from ray_tpu_torch.util.dask import ray_dask_get
    dask.config.set(scheduler=ray_dask_get)   # or compute(scheduler=...)

Gated: raises a clear error if dask is not installed. The port's copy
of ``ray_tpu/util/dask.py``."""

from __future__ import annotations

from typing import Any, Dict, List

import ray_tpu_torch


def _require_dask():
    try:
        import dask  # noqa: F401
        from dask.core import get_dependencies, istask  # noqa: F401
    except ImportError as e:  # pragma: no cover - dask not in image
        raise ImportError(
            "ray_tpu_torch.util.dask needs the `dask` package (not "
            "installed — add it to the environment to use the "
            "shim)") from e


@ray_tpu_torch.remote
def _dask_task(func_and_args):
    func, args = func_and_args
    return func(*args)


def ray_dask_get(dsk: Dict, keys, **_kwargs) -> Any:
    """A dask ``get``: topologically walk the graph, submitting each
    task as a remote task; dependencies pass as ObjectRefs resolved by
    the runtime (zero-copy through the object store)."""
    _require_dask()
    from dask.core import get_dependencies, istask, toposort

    refs: Dict[Any, Any] = {}

    def resolve(v):
        if isinstance(v, list):
            return [resolve(x) for x in v]
        if isinstance(v, tuple) and istask(v):
            func, args = v[0], [resolve(a) for a in v[1:]]
            return func(*[ray_tpu_torch.get(a) if _is_ref(a) else a
                          for a in args])
        if v in refs:
            return refs[v]
        return v

    for key in toposort(dsk):
        val = dsk[key]
        if istask(val):
            func, arg_exprs = val[0], list(val[1:])

            # materialize args: substitute dependency refs
            def subst(expr):
                if isinstance(expr, list):
                    return [subst(x) for x in expr]
                if isinstance(expr, tuple) and istask(expr):
                    f, rest = expr[0], [subst(x) for x in expr[1:]]
                    return (f,) + tuple(rest)
                if expr in refs:
                    return refs[expr]
                return expr

            args = [subst(a) for a in arg_exprs]
            refs[key] = _dask_task.remote((_Evaluator(func), args))
        else:
            refs[key] = resolve(val)

    def fetch(k):
        v = refs[k]
        return ray_tpu_torch.get(v) if _is_ref(v) else v

    if isinstance(keys, list):
        return [fetch(k) if not isinstance(k, list)
                else [fetch(kk) for kk in k] for k in keys]
    return fetch(keys)


class _Evaluator:
    """Evaluates nested dask task expressions inside the worker (inner
    tuples arrive unexecuted; ObjectRef args are already resolved)."""

    def __init__(self, func):
        self.func = func

    def __call__(self, *args):
        from dask.core import istask

        def ev(x):
            if isinstance(x, list):
                return [ev(i) for i in x]
            if isinstance(x, tuple) and istask(x):
                return x[0](*[ev(a) for a in x[1:]])
            return x

        return self.func(*[ev(a) for a in args])


def _is_ref(v) -> bool:
    from ray_tpu_torch.core.object_ref import ObjectRef
    return isinstance(v, ObjectRef)


def enable_dask_on_ray() -> None:
    """Set ray_dask_get as dask's default scheduler."""
    _require_dask()
    import dask
    dask.config.set(scheduler=ray_dask_get)


def disable_dask_on_ray() -> None:
    _require_dask()
    import dask
    dask.config.set(scheduler=None)
