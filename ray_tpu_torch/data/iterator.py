"""Batch iteration + streaming shards for Train workers.

Reference: ``python/ray/data/iterator.py`` (DataIterator) and the
``streaming_split``/``OutputSplitter`` path
(``execution/operators/output_splitter.py``): a coordinator actor feeds
block refs to N shard iterators, so Train workers pull blocks as they
are produced — no full materialization barrier.

The consumer edge is non-blocking end to end: each shard consumes a
``stream_shard`` streaming generator (one ``num_returns="streaming"``
call per shard, refs pushed as they are assigned) instead of one
blocking ``next_block_ref`` RPC per block, and ``iter_batches`` keeps
``prefetch_batches`` resolved blocks in flight on a background thread
so block materialization happens off the consume path. The equal-split
balancer pipelines its row-count lookups
(``DataContext.split_count_pipeline_depth`` refs ahead), so balancing
never stalls the shard stream on a blocking per-block count.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext


def iter_batches_over_blocks(blocks: Iterator[Block],
                             batch_size: Optional[int],
                             batch_format: str,
                             drop_last: bool = False,
                             shuffle_buffer_size: Optional[int] = None,
                             shuffle_seed: Optional[int] = None
                             ) -> Iterator[Any]:
    """Re-chunk a block stream into fixed-size batches; optional local
    shuffle buffer (reference ``iter_batches`` semantics). Consumed
    blocks' shm reader leases release by REFCOUNT the moment the last
    batch/slice alias dies (the lease anchors on the deserialization
    buffer views — see Runtime._cache_shm_value), so streaming an
    over-budget dataset keeps only the working set pinned."""
    rng = np.random.default_rng(shuffle_seed)
    carry: List[pa.Table] = []
    carry_rows = 0
    buffer: List[pa.Table] = []
    buffer_rows = 0

    def emit(table: pa.Table):
        return BlockAccessor(table).to_batch(batch_format)

    def drain_carry():
        nonlocal carry, carry_rows
        merged = BlockAccessor.concat(carry) if len(carry) != 1 else carry[0]
        carry, carry_rows = [], 0
        return merged

    source: Iterator[pa.Table]
    if shuffle_buffer_size:
        def shuffled() -> Iterator[pa.Table]:
            nonlocal buffer, buffer_rows
            for b in blocks:
                buffer.append(b)
                buffer_rows += b.num_rows
                while buffer_rows >= shuffle_buffer_size:
                    merged = BlockAccessor.concat(buffer)
                    perm = rng.permutation(merged.num_rows)
                    merged = BlockAccessor(merged).take(perm)
                    half = merged.num_rows // 2
                    yield merged.slice(0, half)
                    buffer = [merged.slice(half)]
                    buffer_rows = merged.num_rows - half
            if buffer:
                merged = BlockAccessor.concat(buffer)
                perm = rng.permutation(merged.num_rows)
                yield BlockAccessor(merged).take(perm)
        source = shuffled()
    else:
        source = blocks

    if batch_size is None:
        for b in source:
            if b.num_rows:
                yield emit(b)
        return

    for b in source:
        if b.num_rows == 0:
            continue
        carry.append(b)
        carry_rows += b.num_rows
        while carry_rows >= batch_size:
            merged = drain_carry()
            n_full = merged.num_rows // batch_size
            for i in range(n_full):
                yield emit(merged.slice(i * batch_size, batch_size))
            rest = merged.num_rows - n_full * batch_size
            if rest:
                carry = [merged.slice(n_full * batch_size)]
                carry_rows = rest
    if carry_rows and not drop_last:
        yield emit(drain_carry())


class _PrefetchFailed:
    """Error capsule crossing the prefetch thread → consumer boundary."""

    def __init__(self, err: BaseException):
        self.err = err


_PREFETCH_EOF = "__prefetch_eof__"


def prefetch_blocks(refs: Iterator[Any], prefetch: int,
                    stats: Optional[Dict[str, int]] = None
                    ) -> Iterator[Block]:
    """Materialize a block-ref stream keeping up to ``prefetch``
    resolved blocks ahead of the consumer on a background thread. A
    consume-time ``get`` that finds its block already resolved is a
    prefetch *hit*; having to wait is a *miss* (``stats`` accumulates
    both). ``prefetch <= 0`` degrades to inline resolution."""
    if stats is None:
        stats = {}
    stats.setdefault("hits", 0)
    stats.setdefault("misses", 0)
    if prefetch <= 0:
        for ref in refs:
            stats["misses"] += 1
            yield ray_tpu_torch.get(ref)
        return

    import queue as _queue
    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def _pump():
        try:
            for ref in refs:
                if not _put(ray_tpu_torch.get(ref)):
                    return
            _put(_PREFETCH_EOF)
        except BaseException as e:  # noqa: BLE001 — crosses threads
            _put(_PrefetchFailed(e))

    t = threading.Thread(target=_pump, daemon=True,
                         name="ray-tpu-data-prefetch")
    t.start()
    try:
        while True:
            try:
                item = q.get_nowait()
                stats["hits"] += 1
            except _queue.Empty:
                stats["misses"] += 1
                item = q.get()
            if item is _PREFETCH_EOF:
                return
            if isinstance(item, _PrefetchFailed):
                raise item.err
            yield item
    finally:
        stop.set()


class _SplitCoordinator:
    """Actor that routes block refs to shards, balancing assigned ROWS
    greedily (imbalance bounded by one block) so lockstep SPMD consumers
    stay within a block of each other (reference ``OutputSplitter``).
    Only refs flow through the coordinator — blocks move peer-to-peer
    from producer tasks to consuming workers.

    Each shard consumes a ``stream_shard`` streaming generator; the
    shard streams run concurrently on the actor's executor threads
    (``make_streaming_shards`` sizes ``max_concurrency`` for n shards),
    so one lock guards the shared assignment state. Row counts for the
    equal split are PIPELINED: a lookahead of count tasks rides
    ``split_count_pipeline_depth`` refs ahead of assignment, so the
    balancer reads a count that is (almost always) already resolved
    instead of stalling the stream on a blocking per-block RPC."""

    def __init__(self, plan_holder, n: int, equal: bool):
        ds = plan_holder()
        self._it = ds.iter_block_refs()
        self._n = n
        self._equal = equal
        self._queues = [collections.deque() for _ in range(n)]
        self._rows = [0] * n
        self._exhausted = False
        self._next_shard = 0
        self._lock = threading.Lock()
        #: (block_ref, count_ref|None) lookahead — counts in flight
        self._pending: collections.deque = collections.deque()
        self._count_depth = max(
            1, DataContext.get_current().split_count_pipeline_depth)

    # ------------------------------------------------- assignment core
    def _refill_pending(self) -> None:
        """Top the lookahead up: pull upstream refs and launch their
        count tasks so the counts resolve while earlier blocks are
        being assigned/consumed."""
        from ray_tpu_torch.data._internal import shuffle as sh
        while not self._exhausted \
                and len(self._pending) < self._count_depth:
            try:
                ref = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            count_ref = sh._r(sh._rows).remote(ref) if self._equal \
                else None
            self._pending.append((ref, count_ref))

    def _assign_one(self) -> bool:
        self._refill_pending()
        if not self._pending:
            return False
        ref, count_ref = self._pending.popleft()
        self._refill_pending()  # keep counts in flight while we wait
        if self._equal:
            nrows = ray_tpu_torch.get(count_ref)
            shard = min(range(self._n), key=lambda i: self._rows[i])
            self._rows[shard] += nrows
        else:
            shard = self._next_shard
            self._next_shard = (self._next_shard + 1) % self._n
        self._queues[shard].append(ref)
        return True

    def _next_for(self, shard_id: int):
        with self._lock:
            q = self._queues[shard_id]
            while not q:
                if not self._assign_one():
                    return None
            return q.popleft()

    # ---------------------------------------------------- consumer edge
    def stream_shard(self, shard_id: int):
        """Streaming generator of this shard's block refs (consumed via
        ``num_returns="streaming"``): refs are pushed to the consumer
        as they are assigned, replacing one blocking ``next_block_ref``
        RPC per block."""
        while True:
            ref = self._next_for(shard_id)
            if ref is None:
                return
            yield ref

    def next_block_ref(self, shard_id: int):
        """Legacy pull edge: one blocking RPC per block. Returns the
        next block REF for this shard, or None when the stream is
        exhausted."""
        return self._next_for(shard_id)

    def shard_rows(self) -> List[int]:
        """Rows assigned per shard so far (equal-split balance probe)."""
        with self._lock:
            return list(self._rows)


class DataIterator:
    """Per-worker shard handle; picklable (holds an actor handle)."""

    def __init__(self, coordinator, shard_id: int):
        self._coordinator = coordinator
        self._shard_id = shard_id
        self._prefetch_stats: Dict[str, int] = {"hits": 0, "misses": 0}

    def _iter_block_refs(self) -> Iterator[Any]:
        """Consume this shard's ref stream (each stream item is an
        ObjectRef to a block — blocks stay peer-to-peer)."""
        ctx = DataContext.get_current()
        gen = self._coordinator.stream_shard.options(
            num_returns="streaming",
            generator_backpressure_num_objects=max(
                4, 2 * max(ctx.prefetch_batches, 1)),
        ).remote(self._shard_id)
        try:
            for item_ref in gen:
                yield ray_tpu_torch.get(item_ref)
        finally:
            gen.close()

    def _iter_blocks(self, prefetch_batches: Optional[int] = None
                     ) -> Iterator[Block]:
        ctx = DataContext.get_current()
        prefetch = ctx.prefetch_batches if prefetch_batches is None \
            else prefetch_batches
        yield from prefetch_blocks(self._iter_block_refs(), prefetch,
                                   self._prefetch_stats)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_batches: Optional[int] = None,
                     **_ignored) -> Iterator[Any]:
        """``prefetch_batches`` (default ``DataContext.
        prefetch_batches`` = 2) keeps that many RESOLVED blocks ahead
        of the consume path; 0 resolves inline (the old behavior)."""
        yield from iter_batches_over_blocks(
            self._iter_blocks(prefetch_batches), batch_size,
            batch_format, drop_last, local_shuffle_buffer_size,
            local_shuffle_seed)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def prefetch_stats(self) -> Dict[str, int]:
        """Cumulative prefetch hit/miss counters for this shard (a hit
        = the next block was already resolved when the consumer asked
        for it)."""
        return dict(self._prefetch_stats)

    def materialize(self):
        from ray_tpu_torch.data.dataset import MaterializedDataset
        from ray_tpu_torch.data._internal.plan import ExecutionPlan, InputDataOp
        # Reuse the existing block refs — no copy of every block
        # through this process's memory and back into the store.
        refs = list(self._iter_block_refs())
        mds = MaterializedDataset(ExecutionPlan(InputDataOp(refs)))
        # The coordinator owns the blocks; pin it for the refs' lifetime.
        mds._ref_owner = self._coordinator
        return mds


def make_streaming_shards(ds, n: int, equal: bool = True
                          ) -> List[DataIterator]:
    plan = ds._plan

    def plan_holder():
        from ray_tpu_torch.data.dataset import Dataset
        return Dataset(plan)

    # n shard streams run concurrently on the coordinator's executor
    # threads (+ slack for metadata RPCs like shard_rows).
    coord_cls = ray_tpu_torch.remote(num_cpus=0.0,
                                     max_concurrency=n + 4)(_SplitCoordinator)
    coordinator = coord_cls.remote(plan_holder, n, equal)
    return [DataIterator(coordinator, i) for i in range(n)]
