"""Distributed tracing: spans around tasks/actors.

Reference: ``python/ray/util/tracing/tracing_helper.py`` — Ray wraps
task submission/execution in OpenTelemetry spans when the user enables
tracing with an exporter. Here the same layering: if ``opentelemetry``
is importable AND a real (SDK) tracer provider is configured, spans go
to its tracer; otherwise spans fall back to the runtime's built-in
timeline (``ray-tpu timeline`` renders them in the Chrome trace), so
tracing works out of the box with zero extra dependencies.

Cross-process propagation: a ``span()`` also installs a flight-recorder
trace context (``ray_tpu_torch.core.events``) on the current thread, and the
runtime threads that context through task/actor-call submission
(``TaskSpec.trace``) — so both OpenTelemetry (when configured) and the
built-in timeline show parent→child links across processes. On the
executing side, :func:`task_execution_span` re-parents the task's span
under the propagated remote context.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

_enabled = False
_lock = threading.Lock()


def enable_tracing() -> None:
    """Turn on span recording (reference: ``ray.init(_tracing_startup_
    hook=...)``)."""
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def tracing_enabled() -> bool:
    return _enabled


def _is_noop_provider(provider) -> bool:
    """True for OpenTelemetry's built-in exporterless providers. Name
    checks are case-insensitive and paired with a module check because
    the API has renamed these classes across releases (``DefaultTracer
    Provider`` → ``NoOpTracerProvider`` in ≥1.25; ``ProxyTracer
    Provider`` proxies to one until an SDK provider is installed): any
    provider defined inside the ``opentelemetry.trace``/``opentelemetry
    .util`` API packages is exporterless by construction — only an SDK
    (or third-party) provider can actually export spans."""
    cls = type(provider)
    mod = getattr(cls, "__module__", "") or ""
    if mod == "opentelemetry.trace" or \
            mod.startswith(("opentelemetry.trace.", "opentelemetry.util")):
        return True
    name = cls.__name__.lower()
    return any(s in name for s in ("noop", "proxy", "default"))


def _otel_tracer():
    """A real OpenTelemetry tracer, or None. The default/proxy/no-op
    provider doesn't count: with no user-configured exporter the spans
    would vanish — the timeline fallback is strictly more useful."""
    try:
        from opentelemetry import trace
    except ImportError:
        return None
    try:
        provider = trace.get_tracer_provider()
    except Exception:
        return None
    if _is_noop_provider(provider):
        return None
    return trace.get_tracer("ray_tpu_torch")


def _otel_ids(span) -> Optional[Tuple[str, str]]:
    """``(trace_id, span_id)`` hex of an OTel span, or None."""
    try:
        ctx = span.get_span_context()
        return (format(ctx.trace_id, "032x"), format(ctx.span_id, "016x"))
    except Exception:
        return None


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None
         ) -> Iterator[None]:
    """Record one span. OpenTelemetry when available; else the span
    lands in the runtime timeline as a complete event. Either way the
    span becomes the current flight-recorder trace context, so tasks
    submitted inside it carry a parent→child link across processes."""
    if not _enabled:
        yield
        return
    from ray_tpu_torch.core import events as EV
    tracer = _otel_tracer()
    if tracer is not None:
        with tracer.start_as_current_span(name) as s:
            for k, v in (attributes or {}).items():
                s.set_attribute(k, v)
            ids = _otel_ids(s)
            token = EV.set_context(*ids) if ids else None
            try:
                yield
            finally:
                if ids:
                    EV.restore(token)
        return
    # built-in fallback: new span id, inherit (or root) the trace id
    cur = EV.current()
    span_id = EV.new_span_id()
    trace_id = cur[0] if cur is not None else span_id * 2
    token = EV.set_context(trace_id, span_id)
    start = time.time()
    try:
        yield
    finally:
        EV.restore(token)
        dur = time.time() - start
        from ray_tpu_torch.core.global_state import try_global_worker
        w = try_global_worker()
        if w is not None:
            try:
                w.record_span(name, start, dur, trace_id=trace_id,
                              span_id=span_id,
                              parent=cur[1] if cur else None,
                              **(attributes or {}))
            except Exception:
                pass


@contextlib.contextmanager
def task_execution_span(name: str, trace: Optional[tuple]
                        ) -> Iterator[None]:
    """Executing-side half of cross-process propagation: when tracing
    is enabled and a real OTel provider is configured, run the task
    body inside a span whose REMOTE parent is the propagated
    ``TaskSpec.trace`` context — OTel backends then render the same
    parent→child links the flight recorder records. No-op (single
    boolean check) when tracing is off."""
    if not _enabled:
        yield
        return
    tracer = _otel_tracer()
    if tracer is None:
        yield
        return
    try:
        from opentelemetry import trace as otrace
        from opentelemetry.trace import (
            NonRecordingSpan, SpanContext, TraceFlags)
        parent_ctx = None
        if trace and trace[0]:
            parent_span = trace[1]
            sc = SpanContext(
                trace_id=int(trace[0][:32].ljust(32, "0"), 16),
                span_id=int((parent_span or trace[0][:16]).ljust(16, "0"),
                            16),
                is_remote=True, trace_flags=TraceFlags(1))
            parent_ctx = otrace.set_span_in_context(NonRecordingSpan(sc))
    except Exception:
        yield
        return
    with tracer.start_as_current_span(name, context=parent_ctx):
        yield
