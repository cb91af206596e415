"""@serve.batch: dynamic request batching.

Reference: ``python/ray/serve/batching.py`` — calls to the decorated
async method are queued; a background flusher invokes the underlying
function with a LIST of requests once ``max_batch_size`` accumulate or
``batch_wait_timeout_s`` elapses, then fans results back out. On GPU
replicas this is what keeps the tensor cores fed: one padded call per
batch instead of per request.

Queues are **per (instance, running event loop)**: the decorator used to
keep ONE queue in its closure, so every replica of a deployment class
shared it — a mixed batch then executed against ``batch[0][0]`` (the
first submitter's ``self``) only, silently feeding other instances'
requests through one instance's weights. Keying by instance fixes that,
and keying by the running loop re-creates the flusher task when a later
caller lives on a different event loop (the old ``_ensure`` pinned the
first caller's loop forever, wedging replicas created on a new loop —
e.g. a restarted async actor).
"""

from __future__ import annotations

import asyncio
import functools
import weakref
from typing import Any, Callable, List, Optional, Tuple


class _BatchQueue:
    """One queue + flusher bound to one (instance, event loop)."""

    def __init__(self, fn, instance, max_batch_size: int,
                 timeout_s: float):
        self._fn = fn
        self._instance = instance
        self._max = max_batch_size
        self._timeout = timeout_s
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task = asyncio.get_event_loop().create_task(self._flusher())

    async def submit(self, item):
        fut = asyncio.get_event_loop().create_future()
        await self._queue.put((item, fut))
        return await fut

    async def _flusher(self):
        while True:
            item, fut = await self._queue.get()
            batch = [(item, fut)]
            deadline = asyncio.get_event_loop().time() + self._timeout
            while len(batch) < self._max:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout=remaining))
                except asyncio.TimeoutError:
                    break
            items = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            try:
                out = self._fn(self._instance, items)
                if asyncio.iscoroutine(out):
                    out = await out
                if len(out) != len(items):
                    raise ValueError(
                        f"@serve.batch function returned {len(out)} "
                        f"results for {len(items)} requests")
                for f, r in zip(futs, out):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:
                for f in futs:
                    if not f.done():
                        f.set_exception(e)


class _QueueRegistry:
    """Queues keyed per (instance, running loop). Instances are held
    weakly so a torn-down replica's queue can be collected; a dead or
    changed loop gets a fresh queue + flusher (the old flusher task
    died with its loop)."""

    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = timeout_s
        self._queues: "weakref.WeakKeyDictionary[Any, Tuple]" = \
            weakref.WeakKeyDictionary()

    def __getstate__(self):
        # Deployment classes are cloudpickled to replica actors with
        # this registry hanging off the decorated method. Queues and
        # flusher tasks are process-local (bound to instances and event
        # loops that don't travel) — ship only the config.
        return {"_fn": self._fn, "_max": self._max,
                "_timeout": self._timeout}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._queues = weakref.WeakKeyDictionary()

    def queue_for(self, instance) -> _BatchQueue:
        loop = asyncio.get_event_loop()
        try:
            entry = self._queues.get(instance)
        except TypeError:   # unhashable/non-weakrefable instance
            entry = getattr(instance, "__serve_batch_queue__", None)
        if entry is not None:
            q_loop, q = entry
            if q_loop is loop and not loop.is_closed():
                return q
        q = _BatchQueue(self._fn, instance, self._max, self._timeout)
        try:
            self._queues[instance] = (loop, q)
        except TypeError:
            setattr(instance, "__serve_batch_queue__", (loop, q))
        return q


def batch(_fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorate an async method taking a LIST of requests."""
    def wrap(fn):
        registry = _QueueRegistry(fn, max_batch_size,
                                  batch_wait_timeout_s)

        @functools.wraps(fn)
        async def wrapper(self, item):
            return await registry.queue_for(self).submit(item)

        wrapper._batch_registry = registry
        return wrapper
    if _fn is not None:
        return wrap(_fn)
    return wrap
