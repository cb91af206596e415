"""Actor-backed distributed Queue (reference: ``python/ray/util/queue.py``)."""

from __future__ import annotations

import asyncio
import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote(num_cpus=0.1)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = []
        self._maxsize = maxsize

    def qsize(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def full(self) -> bool:
        return self._maxsize > 0 and len(self._q) >= self._maxsize

    def put(self, item) -> bool:
        if self._maxsize > 0 and len(self._q) >= self._maxsize:
            return False
        self._q.append(item)
        return True

    def get(self):
        if not self._q:
            return False, None
        return True, self._q.pop(0)

    def put_batch(self, items: List[Any]) -> int:
        n = 0
        for item in items:
            if self._maxsize > 0 and len(self._q) >= self._maxsize:
                break
            self._q.append(item)
            n += 1
        return n

    def get_batch(self, n: int) -> List[Any]:
        out, self._q = self._q[:n], self._q[n:]
        return out


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = actor_options or {}
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(self, item, block: bool = True, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if not block or (deadline and time.monotonic() >= deadline):
                raise Full()
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get.remote())
            if ok:
                return item
            if not block or (deadline and time.monotonic() >= deadline):
                raise Empty()
            time.sleep(0.01)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        n = ray_tpu_torch.get(self.actor.put_batch.remote(list(items)))
        if n < len(items):
            raise Full()

    def get_nowait_batch(self, n: int) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_batch.remote(n))

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
