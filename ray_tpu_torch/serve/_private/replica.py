"""Replica: the actor executing user deployment code.

Reference: ``python/ray/serve/_private/replica.py`` — wraps the user
class/function, counts in-flight requests (the router probes this for
power-of-two-choices), runs health checks, applies user_config
reconfiguration. Function deployments get a synthesized callable class.
"""

from __future__ import annotations

import contextvars
import inspect
from typing import Any, Dict

#: Request-scoped metadata (reference: serve.context._serve_request_context);
#: read by ``serve.get_multiplexed_model_id()`` inside user code.
_request_context: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "serve_request_context", default={})


def get_multiplexed_model_id() -> str:
    """The model id the current request was routed with (reference:
    ``serve.get_multiplexed_model_id``, python/ray/serve/api.py)."""
    return _request_context.get().get("multiplexed_model_id", "")


def get_request_context() -> Dict[str, Any]:
    """Full request-scoped routing context for the current request:
    ``request_id`` and the router's ``trace`` stamp (sampling verdict,
    enqueue timestamp, routing policy/score, admission verdict) in
    addition to the multiplexed model id. Empty dict outside a
    request."""
    return _request_context.get()


class Replica:
    def __init__(self, func_or_class, init_args, init_kwargs,
                 user_config=None, deployment_name: str = "",
                 replica_id: str = ""):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        self._num_ongoing = 0
        self._num_total = 0
        if isinstance(func_or_class, type):
            self._instance = func_or_class(*init_args, **init_kwargs)
        elif callable(func_or_class):
            fn = func_or_class
            class _FnWrapper:
                def __call__(self, *a, **kw):
                    return fn(*a, **kw)
            self._instance = _FnWrapper()
        else:
            raise TypeError(f"Not deployable: {func_or_class!r}")
        if user_config is not None:
            self.reconfigure(user_config)

    async def handle_request(self, method_name: str, *args, **kwargs):
        self._num_ongoing += 1
        self._num_total += 1
        try:
            method = getattr(self._instance, method_name)
            out = method(*args, **kwargs)
            if inspect.iscoroutine(out):
                out = await out
            return out
        finally:
            self._num_ongoing -= 1

    async def handle_request_ctx(self, ctx: dict, method_name: str,
                                 *args, **kwargs):
        """Like handle_request, with request-scoped context (multiplexed
        model id) visible to user code via get_multiplexed_model_id()."""
        token = _request_context.set(ctx or {})
        try:
            return await self.handle_request(method_name, *args, **kwargs)
        finally:
            _request_context.reset(token)

    # -- streaming (reference: RayServeHandle options(stream=True) →
    # DeploymentResponseGenerator): the handle calls this with
    # num_returns="streaming", so each yielded item becomes its own
    # core object, eagerly reported and consumer-paced by the core
    # backpressure window — there is no replica-held live-generator
    # table and no next_chunks polling protocol anymore. Early consumer
    # termination cancels this task; the finally/close path restores
    # the ongoing-count used for load balancing.
    async def handle_request_stream(self, ctx: dict, method_name: str,
                                    *args, **kwargs):
        self._num_ongoing += 1
        self._num_total += 1
        try:
            token = _request_context.set(ctx or {})
            try:
                method = getattr(self._instance, method_name)
                out = method(*args, **kwargs)
                if inspect.iscoroutine(out):
                    out = await out
            finally:
                _request_context.reset(token)
            if not (inspect.isgenerator(out) or inspect.isasyncgen(out)
                    or hasattr(out, "__iter__")):
                raise TypeError(
                    f"options(stream=True) requires {method_name!r} to "
                    f"return a generator, got {type(out).__name__}")
            is_async = inspect.isasyncgen(out)
            it = out if is_async else iter(out)
            while True:
                # the request context must be visible to the generator
                # BODY, which only runs inside this pull — and each pull
                # of an async generator runs in a fresh task context, so
                # a one-shot set at creation would not stick
                token = _request_context.set(ctx or {})
                try:
                    if is_async:
                        try:
                            item = await it.__anext__()
                        except StopAsyncIteration:
                            break
                    else:
                        try:
                            item = next(it)
                        except StopIteration:
                            break
                finally:
                    _request_context.reset(token)
                yield item
        finally:
            self._num_ongoing -= 1

    async def prepare_drain(self, min_hits: int = 1,
                            max_blocks: int = 0):
        """Downscale hook: before the controller kills this replica,
        ask an engine-aware deployment for its warm-prefix export so a
        survivor can adopt it (warm-prefix migration). Deployments
        without ``export_warm_prefixes`` drain with nothing to say."""
        fn = getattr(self._instance, "export_warm_prefixes", None)
        if fn is None:
            return None
        out = fn(min_hits=min_hits, max_blocks=max_blocks)
        if inspect.iscoroutine(out):
            out = await out
        return out

    def num_ongoing_requests(self) -> int:
        return self._num_ongoing

    def reconfigure(self, user_config) -> None:
        fn = getattr(self._instance, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    def check_health(self) -> bool:
        fn = getattr(self._instance, "check_health", None)
        if fn is not None:
            fn()
        return True

    def stats(self) -> Dict[str, Any]:
        import os
        # pid lets gauge-aware routers map this replica onto the fleet
        # metrics plane's per-origin rows when direct probes go quiet
        out = {"replica_id": self.replica_id,
               "ongoing": self._num_ongoing,
               "total": self._num_total,
               "pid": os.getpid()}
        # engine-aware deployments (LLMServer & friends) expose their
        # scheduler counters; surface them for the autoscaler's
        # engine-gauge scale-up signals (queue depth, TTFT)
        fn = getattr(self._instance, "stats", None)
        if callable(fn):
            try:
                engine = fn()
                if isinstance(engine, dict):
                    out["engine"] = engine
            except Exception:
                pass
        return out
