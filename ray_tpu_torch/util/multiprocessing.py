"""multiprocessing.Pool shim over tasks.

Reference: ``python/ray/util/multiprocessing/pool.py`` — the drop-in
``Pool`` API (map/starmap/apply/imap/async variants) executing on the
cluster instead of local processes. The port's copy of
``ray_tpu/util/multiprocessing.py``.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs, single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs if isinstance(self._refs, list)
                     else [self._refs],
                     num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class _PoolWorker:
    """One pool slot: an actor, so ``processes`` truly bounds
    concurrency (the reference Pool is also actor-backed)."""

    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **kwargs)


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_remote_args: Optional[dict] = None):
        self._n = processes or 8
        self._remote_args = ray_remote_args or {"num_cpus": 1}
        self._closed = False
        actor_cls = ray_tpu_torch.remote(**self._remote_args)(_PoolWorker)
        self._workers = [actor_cls.remote(initializer, initargs)
                         for _ in range(self._n)]
        self._rr = 0

    def _submit(self, fn, args, kwargs):
        worker = self._workers[self._rr % self._n]
        self._rr += 1
        return worker.run.remote(fn, args, kwargs)

    def _check(self):
        if self._closed:
            raise ValueError("Pool is closed")

    # -- apply --------------------------------------------------------
    def apply(self, fn, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check()
        return AsyncResult(
            [self._submit(fn, args, kwds or {})], single=True)

    # -- map ----------------------------------------------------------
    def map(self, fn, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check()
        refs = [self._submit(fn, (x,), {}) for x in iterable]
        return AsyncResult(refs)

    def starmap(self, fn, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(fn, iterable).get()

    def starmap_async(self, fn, iterable: Iterable[tuple]) -> AsyncResult:
        self._check()
        refs = [self._submit(fn, tuple(x), {}) for x in iterable]
        return AsyncResult(refs)

    def imap(self, fn, iterable: Iterable, chunksize: int = 1):
        self._check()
        refs = [self._submit(fn, (x,), {}) for x in iterable]
        for ref in refs:
            yield ray_tpu_torch.get(ref)

    def imap_unordered(self, fn, iterable: Iterable, chunksize: int = 1):
        self._check()
        pending = [self._submit(fn, (x,), {}) for x in iterable]
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield ray_tpu_torch.get(ready[0])

    # -- lifecycle ----------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []

    def join(self) -> None:
        if not self._closed:
            raise ValueError("join() before close()")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
