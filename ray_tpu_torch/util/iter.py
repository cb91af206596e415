"""Parallel iterators (reference: ``python/ray/util/iter.py`` —
``from_items``/``from_iterators``/``from_range`` producing a
``ParallelIterator`` of sharded streams backed by actors, with
``for_each``/``filter``/``batch``/``gather_sync``/``gather_async``/
``union``/``repartition``). The port's copy of ``ray_tpu/util/iter.py``."""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, List, TypeVar

import ray_tpu_torch

T = TypeVar("T")
U = TypeVar("U")


def from_items(items: List[T], num_shards: int = 2,
               repeat: bool = False) -> "ParallelIterator[T]":
    shards = [items[i::num_shards] for i in range(num_shards)]
    return from_iterators(
        [(lambda s=s: iter(s)) for s in shards], repeat=repeat,
        name=f"from_items[{len(items)}]")


def from_range(n: int, num_shards: int = 2,
               repeat: bool = False) -> "ParallelIterator[int]":
    bounds = [(i * n // num_shards, (i + 1) * n // num_shards)
              for i in range(num_shards)]
    return from_iterators(
        [(lambda lo=lo, hi=hi: iter(range(lo, hi)))
         for lo, hi in bounds],
        repeat=repeat, name=f"from_range[{n}]")


def from_iterators(creators: List[Callable[[], Iterable[T]]],
                   repeat: bool = False,
                   name: str = "from_iterators"
                   ) -> "ParallelIterator[T]":
    return ParallelIterator(
        [_IterShard.remote(c, repeat) for c in creators], name)


@ray_tpu_torch.remote(num_cpus=0.25)
class _IterShard:
    """Actor hosting one shard's iterator + its transform chain."""

    def __init__(self, creator: Callable[[], Iterable], repeat: bool):
        self._creator = creator
        self._repeat = repeat
        self._ops: List[Any] = []
        self._it: Iterator = None  # type: ignore[assignment]
        self._reset()

    def _reset(self) -> None:
        base = iter(self._creator())
        if self._repeat:
            base = itertools.chain.from_iterable(
                iter(self._creator()) for _ in itertools.count())
        it = base
        for kind, fn in self._ops:
            it = _apply_op(it, kind, fn)
        self._it = it

    def push_op(self, kind: str, fn: Any) -> None:
        self._ops.append((kind, fn))
        self._reset()

    def next_batch(self, n: int) -> List[Any]:
        out = list(itertools.islice(self._it, n))
        return out


def _apply_op(it: Iterator, kind: str, fn: Any) -> Iterator:
    if kind == "for_each":
        return map(fn, it)
    if kind == "filter":
        return filter(fn, it)
    if kind == "batch":
        def batched(src=it, size=fn):
            while True:
                chunk = list(itertools.islice(src, size))
                if not chunk:
                    return
                yield chunk
        return batched()
    if kind == "flatten":
        return itertools.chain.from_iterable(it)
    raise ValueError(kind)


class ParallelIterator:
    """Handle over sharded remote iterators."""

    def __init__(self, shards: List[Any], name: str):
        self._shards = shards
        self.name = name

    def __repr__(self):
        return f"ParallelIterator[{self.name}, {len(self._shards)} shards]"

    def num_shards(self) -> int:
        return len(self._shards)

    # -- transforms (lazy, applied shard-side) -------------------------
    def for_each(self, fn: Callable[[T], U]) -> "ParallelIterator[U]":
        ray_tpu_torch.get([s.push_op.remote("for_each", fn)
                     for s in self._shards])
        return self

    def filter(self, fn: Callable[[T], bool]) -> "ParallelIterator[T]":
        ray_tpu_torch.get([s.push_op.remote("filter", fn)
                     for s in self._shards])
        return self

    def batch(self, n: int) -> "ParallelIterator[List[T]]":
        ray_tpu_torch.get([s.push_op.remote("batch", n)
                     for s in self._shards])
        return self

    def flatten(self) -> "ParallelIterator[Any]":
        ray_tpu_torch.get([s.push_op.remote("flatten", None)
                     for s in self._shards])
        return self

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        return ParallelIterator(self._shards + other._shards,
                                f"union({self.name},{other.name})")

    # -- consumption ---------------------------------------------------
    def gather_sync(self, batch: int = 64) -> Iterator[T]:
        """Round-robin over shards, in shard order (deterministic)."""
        live = list(self._shards)
        while live:
            futs = [s.next_batch.remote(batch) for s in live]
            results = ray_tpu_torch.get(futs)
            nxt = []
            for s, chunk in zip(live, results):
                yield from chunk
                if len(chunk) == batch:
                    nxt.append(s)
            live = nxt

    def gather_async(self, batch: int = 64) -> Iterator[T]:
        """Yield from whichever shard is ready first."""
        pending = {s.next_batch.remote(batch): s for s in self._shards}
        while pending:
            ready, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
            fut = ready[0]
            shard = pending.pop(fut)
            chunk = ray_tpu_torch.get(fut)
            yield from chunk
            if len(chunk) == batch:
                pending[shard.next_batch.remote(batch)] = shard

    def take(self, n: int) -> List[T]:
        out = []
        for item in self.gather_sync():
            out.append(item)
            if len(out) >= n:
                break
        return out

    def stop(self) -> None:
        for s in self._shards:
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass
