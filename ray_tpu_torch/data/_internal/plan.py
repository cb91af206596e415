"""Logical plan + fused streaming execution.

Reference: ``python/ray/data/_internal/plan.py`` (ExecutionPlan),
``logical/`` operators, and ``execution/streaming_executor.py:55``. The
design keeps the reference's two key properties, re-expressed compactly:

- **operator fusion**: consecutive one-to-one ops (read→map→filter…)
  fuse into a single stage per block (reference
  ``logical/rules/operator_fusion.py``), so a ``read_parquet →
  map_batches → filter`` chain costs one hop per block, not three.
- **generator-fed streaming**: each fused stage is a small pool of
  long-lived ``num_returns="streaming"`` generators (tasks for
  stateless stages — lineage-replayable on a mid-stream worker kill —
  or actor-pool members for callable-class UDFs and stream-fed
  stages). A stage member consumes its slice of the upstream items and
  yields one output block per input the moment it exists, so stage
  N+1 starts on stage N's FIRST block instead of after an in-order
  submission window drains. Backpressure is the streaming layer's
  consumer-paced credit window: ``DataContext.
  max_tasks_in_flight_per_operator`` is split across the stage's
  members and mapped onto ``generator_backpressure_num_objects``, so a
  slow consumer blocks the producers at the window instead of flooding
  the object store. Completion order is surfaced via ``wait_any``;
  ``DataContext.preserve_order`` (default True) keeps the submission-
  order yield ``sort``/``limit``/``take`` assume.

``DataContext.execution_mode = "staged"`` selects the serialized
baseline (per-block tasks, in-order window, materialize barrier between
stages) that ``bench.py --data`` measures the streaming executor
against.

All-to-all ops (shuffle/sort/repartition) are barriers, as in the
reference's exchange operators (``planner/exchange/``).
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, _to_table
from ray_tpu_torch.data.context import DataContext


# ---------------------------------------------------------------- ops
@dataclass
class ReadOp:
    """Source: a list of zero-arg callables each producing a Block."""
    tasks: List[Callable[[], Block]]
    name: str = "Read"


@dataclass
class InputDataOp:
    """Source: pre-materialized block refs."""
    block_refs: List[Any]
    name: str = "InputData"


@dataclass
class OneToOneOp:
    """A per-block transform: fn(Block) -> Block. Fusable."""
    fn: Callable[[Block], Block]
    name: str = "Map"
    # actor-pool compute (None = task pool)
    actor_pool_size: Optional[int] = None
    fn_constructor: Optional[Callable[[], Any]] = None
    num_cpus: Optional[float] = None


@dataclass
class AllToAllOp:
    """Barrier op over the full materialized block list."""
    fn: Callable[[List[Any]], List[Any]]  # refs -> refs
    name: str = "AllToAll"


@dataclass
class ExchangeOp:
    """Pipelined all-to-all (reference: planner/exchange/ operators fed
    by the streaming executor): ``run`` receives the upstream ref
    ITERATOR so map-side tasks launch as blocks materialize; only the
    reduce phase barriers. ``count_hint`` is the statically-known
    upstream block count (None after limit/union)."""
    run: Callable[..., List[Any]]  # (ref_iter, count_hint) -> refs
    name: str = "Exchange"
    #: statically-known output block count (repartition(n)); None keeps
    #: the upstream count (shuffle/sort)
    out_count: Optional[int] = None


@dataclass
class LimitOp:
    n: int
    name: str = "Limit"


@dataclass
class UnionOp:
    others: List["ExecutionPlan"]
    name: str = "Union"


class ExecutionPlan:
    def __init__(self, source, ops: Optional[List[Any]] = None):
        self.source = source  # ReadOp | InputDataOp
        self.ops: List[Any] = ops or []

    def with_op(self, op) -> "ExecutionPlan":
        return ExecutionPlan(self.source, self.ops + [op])

    def source_len(self) -> int:
        if isinstance(self.source, ReadOp):
            return len(self.source.tasks)
        return len(self.source.block_refs)

    def __repr__(self):
        names = [getattr(self.source, "name", "?")] + [
            op.name for op in self.ops]
        return " -> ".join(names)


# ----------------------------------------------------------- execution
def _apply_chain(fns: List[Callable[[Block], Block]], item) -> Block:
    """The fused stage body: run a producer or block through the chain
    of one-to-one transforms. Runs remotely, one task per block."""
    block = item() if callable(item) else item
    for fn in fns:
        block = fn(block)
    return block


def _materialize_item(item) -> Block:
    """An upstream item is a ready Block, a read callable, or a block
    ref (nested in the items list, so not auto-resolved)."""
    from ray_tpu_torch.core.object_ref import ObjectRef
    if isinstance(item, ObjectRef):
        return ray_tpu_torch.get(item)
    return item() if callable(item) else item


def _stage_stream(fns: List[Callable], items: List[Any]):
    """Long-lived generator-task stage member: consumes its slice of
    the upstream items and yields one output block per input. Runs as
    ``num_returns="streaming"`` so downstream starts on the first
    yield; deterministic in its args, so a mid-stream worker SIGKILL
    lineage-replays the stream prefix exactly-once."""
    for item in items:
        block = _materialize_item(item)
        for fn in fns:
            block = fn(block)
        yield block


class _ActorStage:
    """Actor holding stateful transform constructors for an actor-pool
    stage (reference ``ActorPoolMapOperator``; callable-class UDFs).
    Used by the ``staged`` baseline executor."""

    def __init__(self, constructors: List[Optional[Callable]]):
        self._instances = [c() if c is not None else None
                           for c in constructors]

    def apply(self, fns: List[Callable], item) -> Block:
        block = item() if callable(item) else item
        for fn, inst in zip(fns, self._instances):
            if inst is not None:
                block = fn(block, inst)
            else:
                block = fn(block)
        return block


class _StageWorker:
    """Long-lived actor-pool stage member for the streaming executor:
    the driver ``feed``s it upstream items (block refs travel as
    top-level args, so the block moves producer→worker peer-to-peer —
    the driver only routes refs) and its ``run`` streaming generator
    applies the fused chain, yielding one output block per input.

    Runs with ``max_concurrency >= 2``: ``run`` blocks on the mailbox
    while ``feed``/``finish`` calls land (same mailbox discipline as
    ``parallel/mpmd_pipeline.PipelineStage``). The mailbox is INDEXED:
    concurrent actor calls are *admitted* in submission order but race
    on the executor threads, so ``feed`` carries its per-worker
    sequence number and ``finish`` the total count — ``run`` processes
    strictly by index and only exits once every fed item is done, so a
    ``finish`` overtaking a late ``feed`` can neither drop nor reorder
    blocks."""

    FEED_TIMEOUT_S = 600.0

    def __init__(self, constructors: Optional[List[Optional[Callable]]]):
        self._instances = [c() if c is not None else None
                           for c in (constructors or [])]
        self._box: Dict[int, Any] = {}
        self._cond = threading.Condition()
        self._expected: Optional[int] = None

    def feed(self, i: int, item) -> None:
        with self._cond:
            self._box[i] = item
            self._cond.notify_all()

    def finish(self, count: int) -> None:
        with self._cond:
            self._expected = count
            self._cond.notify_all()

    def run(self, fns: List[Callable]):
        import time as _time
        i = 0
        while True:
            deadline = _time.monotonic() + self.FEED_TIMEOUT_S
            with self._cond:
                while i not in self._box and \
                        (self._expected is None or i < self._expected):
                    if _time.monotonic() > deadline:
                        raise TimeoutError(
                            f"stage worker starved waiting for item {i} "
                            f"(driver pump dead?)")
                    self._cond.wait(0.1)
                if i not in self._box:
                    return  # every fed item processed
                item = self._box.pop(i)
            i += 1
            block = item() if callable(item) else item
            if self._instances:
                for fn, inst in zip(fns, self._instances):
                    block = fn(block, inst) if inst is not None \
                        else fn(block)
            else:
                for fn in fns:
                    block = fn(block)
            yield block


def _fuse(ops: List[Any]) -> List[Any]:
    """Group consecutive OneToOneOps with compatible compute into fused
    stages; barrier/limit ops pass through."""
    fused: List[Any] = []
    buf: List[OneToOneOp] = []

    def flush():
        if buf:
            fused.append(list(buf))
            buf.clear()

    prev_pool: Optional[int] = None
    for op in ops:
        if isinstance(op, OneToOneOp):
            if buf and op.actor_pool_size != prev_pool:
                flush()
            buf.append(op)
            prev_pool = op.actor_pool_size
        else:
            flush()
            fused.append(op)
    flush()
    return fused


def execute_streaming(plan: ExecutionPlan,
                      ctx: Optional[DataContext] = None
                      ) -> Iterator[Any]:
    """Yield output block refs. In the default ``streaming`` mode the
    fused stages run as generator pools paced by the credit window; in
    ``staged`` mode, per-block tasks with an in-order window of
    ``ctx.max_tasks_in_flight_per_operator`` and a barrier per stage."""
    ctx = ctx or DataContext.get_current()

    # Source items: callables (read tasks) or ready refs.
    if isinstance(plan.source, ReadOp):
        items: List[Any] = list(plan.source.tasks)
        items_are_refs = False
    else:
        items = list(plan.source.block_refs)
        items_are_refs = True

    stages = _fuse(plan.ops)
    stream = _run_stages(items, items_are_refs, stages, ctx,
                         plan.source_len())
    yield from stream


def _run_stages(items, items_are_refs: bool,
                stages: List[Any], ctx: DataContext,
                count_hint: Optional[int] = None) -> Iterator[Any]:
    streaming = ctx.execution_mode != "staged"
    if not stages:
        # Source only: materialize reads into refs.
        if items_are_refs:
            yield from iter(items)
        elif streaming and isinstance(items, list):
            yield from _run_fused_stage_streaming(
                items, False, [OneToOneOp(lambda b: b, name="Read")],
                ctx)
        else:
            yield from _window_map(
                iter(items), lambda task: _remote_apply([], task), ctx)
        return

    stage, rest = stages[0], stages[1:]
    if isinstance(stage, list):  # fused one-to-one stage
        if streaming:
            out = _run_fused_stage_streaming(items, items_are_refs,
                                             stage, ctx)
        else:
            out = _run_fused_stage(iter(items), items_are_refs, stage,
                                   ctx)
            if rest:
                # staged baseline: a real materialize barrier — pace
                # completions through the in-order window, and only
                # start the next stage once every block exists
                out = _window_barrier(out, ctx)
        yield from _run_stages(out, True, rest, ctx, count_hint)
    elif isinstance(stage, ExchangeOp):
        upstream = _run_stages(items, items_are_refs, [], ctx,
                               count_hint)
        out_refs = stage.run(upstream, count_hint)
        yield from _run_stages(list(out_refs), True, rest, ctx,
                               len(out_refs))
    elif isinstance(stage, AllToAllOp):
        refs = list(_run_stages(items, items_are_refs, [], ctx,
                                count_hint))
        out_refs = stage.fn(refs)
        yield from _run_stages(list(out_refs), True, rest, ctx,
                               len(out_refs))
    elif isinstance(stage, LimitOp):
        out = _run_limit(
            _run_stages(items, items_are_refs, [], ctx, count_hint),
            stage.n)
        # limit truncates an unknown number of blocks: no hint below
        yield from _run_stages(out, True, rest, ctx, None)
    elif isinstance(stage, UnionOp):
        def chained():
            yield from _run_stages(items, items_are_refs, [], ctx,
                                   count_hint)
            for other in stage.others:
                yield from execute_streaming(other, ctx)
        # other branches' output counts aren't statically derived here
        yield from _run_stages(chained(), True, rest, ctx, None)
    else:
        raise TypeError(f"Unknown stage: {stage!r}")


_remote_apply_cached: Dict[float, Any] = {}


def _get_remote_apply(num_cpus: float = 1.0):
    if num_cpus not in _remote_apply_cached:
        _remote_apply_cached[num_cpus] = ray_tpu_torch.remote(
            num_cpus=num_cpus)(_apply_chain)
    return _remote_apply_cached[num_cpus]


def _remote_apply(fns, item, num_cpus: float = 1.0):
    return _get_remote_apply(num_cpus).remote(fns, item)


_stage_stream_cached: Dict[float, Any] = {}


def _get_stage_stream(num_cpus: float = 1.0):
    if num_cpus not in _stage_stream_cached:
        _stage_stream_cached[num_cpus] = ray_tpu_torch.remote(
            num_cpus=num_cpus, num_returns="streaming")(_stage_stream)
    return _stage_stream_cached[num_cpus]


def _window_barrier(refs: Iterator[Any], ctx: DataContext) -> List[Any]:
    """Staged-baseline stage barrier: consume the windowed ref stream
    waiting on each completion in submission order (so the in-order
    window actually bounds in-flight tasks), returning only once the
    whole stage is materialized."""
    out: List[Any] = []
    for ref in refs:
        try:
            ray_tpu_torch.wait([ref], num_returns=1, timeout=600)
        except Exception:
            pass
        out.append(ref)
    return out


def _window_map(items: Iterator[Any], submit: Callable[[Any], Any],
                ctx: DataContext) -> Iterator[Any]:
    """Submit tasks keeping a bounded in-flight window; yield refs in
    order (the ``staged`` baseline's in-order submission window)."""
    window = ctx.max_tasks_in_flight_per_operator
    inflight: List[Any] = []
    for item in items:
        inflight.append(submit(item))
        if len(inflight) >= window:
            yield inflight.pop(0)
    while inflight:
        yield inflight.pop(0)


# ----------------------------------------- streaming (generator-fed)
def _stage_pool_size(stage: List[OneToOneOp], n_items: Optional[int],
                     ctx: DataContext) -> int:
    pool = stage[0].actor_pool_size
    if pool is None:
        pool = ctx.streaming_stage_parallelism \
            or ctx.max_tasks_in_flight_per_operator
    if n_items is not None:
        pool = min(pool, max(n_items, 1))
    return max(1, pool)


def _drain_one(gen, timeout: float = 600.0):
    """Pull the next item ref from a stage stream; None at EOF."""
    try:
        return gen.next_ref(timeout=timeout)
    except StopIteration:
        return None


def _run_fused_stage_streaming(items, items_are_refs: bool,
                               stage: List[OneToOneOp], ctx: DataContext
                               ) -> Iterator[Any]:
    """Run one fused stage as a pool of long-lived streaming
    generators. Static (list) upstreams with task compute become
    lineage-replayable generator TASKS over round-robin slices;
    actor-pool stages and dynamically-fed (stream) upstreams become
    ``_StageWorker`` actors pumped by the driver."""
    fns = [op.fn for op in stage]
    stage_cpus = max((op.num_cpus or 1.0) for op in stage)
    window = max(1, ctx.max_tasks_in_flight_per_operator)
    static = isinstance(items, list)
    pool_cfg = stage[0].actor_pool_size
    n_items = len(items) if static else None
    k = _stage_pool_size(stage, n_items, ctx)
    # ceil(window / k), floored at 2: a window of 1 would cost one
    # credit round-trip per block (yield → stall → credit → yield)
    per_gen_bp = max(2, -(-window // k))

    if static and not items:
        return
    if static and pool_cfg is None:
        yield from _run_static_task_stage(items, fns, stage_cpus, k,
                                          per_gen_bp, ctx)
        return
    constructors = [op.fn_constructor for op in stage] \
        if pool_cfg is not None else None
    yield from _run_fed_actor_stage(
        iter(items), fns, constructors, stage_cpus, k, per_gen_bp,
        window, ctx)


def _run_static_task_stage(items: List[Any], fns, stage_cpus: float,
                           k: int, per_gen_bp: int, ctx: DataContext
                           ) -> Iterator[Any]:
    """k long-lived generator tasks over round-robin item slices."""
    remote_fn = _get_stage_stream(stage_cpus)
    gens = [remote_fn.options(
        generator_backpressure_num_objects=per_gen_bp).remote(
            fns, items[i::k]) for i in range(k)]
    try:
        if ctx.preserve_order:
            yield from _consume_round_robin(gens, len(items))
        else:
            yield from _consume_completion_order(gens)
    finally:
        for g in gens:
            try:
                g.close()
            except Exception:
                pass


def _run_fed_actor_stage(items: Iterator[Any], fns, constructors,
                         stage_cpus: float, k: int, per_gen_bp: int,
                         window: int, ctx: DataContext) -> Iterator[Any]:
    """k ``_StageWorker`` actors fed round-robin by the driver with a
    bounded feed-ahead; outputs drained from their ``run`` streams."""
    actor_cls = ray_tpu_torch.remote(num_cpus=stage_cpus,
                               max_concurrency=4)(_StageWorker)
    workers = [actor_cls.remote(constructors) for _ in range(k)]
    gens = [w.run.options(
        num_returns="streaming",
        generator_backpressure_num_objects=per_gen_bp).remote(fns)
        for w in workers]
    fed = 0
    consumed = 0
    fed_per_worker = [0] * k
    exhausted = False
    feed_ahead = max(window, k)
    try:
        while True:
            while not exhausted and fed - consumed < feed_ahead:
                try:
                    item = next(items)
                except StopIteration:
                    exhausted = True
                    for w, count in zip(workers, fed_per_worker):
                        w.finish.remote(count)
                    break
                wi = fed % k
                workers[wi].feed.remote(fed_per_worker[wi], item)
                fed_per_worker[wi] += 1
                fed += 1
            if exhausted and consumed >= fed:
                break
            if ctx.preserve_order:
                ref = _drain_one(gens[consumed % k])
                if ref is None:
                    raise RuntimeError(
                        f"stage stream {consumed % k} ended early at "
                        f"output {consumed}/{fed}")
                consumed += 1
                yield ref
            else:
                from ray_tpu_torch.core.streaming import wait_any
                active = [g for g in gens if not g.is_finished()]
                if not active:
                    break
                ready, _ = wait_any(active, timeout=600.0)
                if not ready:
                    raise TimeoutError(
                        "fused stage made no progress in 600s")
                got = False
                for g in ready:
                    burst = g.ready_refs()
                    if burst:
                        got = True
                        for ref in burst:
                            consumed += 1
                            yield ref
                    else:
                        # ready with nothing buffered: EOF (consume the
                        # StopIteration so the stream record is freed)
                        # or a failure — surfaced typed right here.
                        _drain_one(g, timeout=0.1)
                if not got and all(g.is_finished() for g in gens):
                    break
    finally:
        for g in gens:
            try:
                g.close()
            except Exception:
                pass
        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass


def _consume_round_robin(gens, total: int) -> Iterator[Any]:
    """Submission-order yield: output j comes from generator j % k
    (items were sliced round-robin), so global order is preserved while
    every member still computes ahead inside its credit window."""
    k = len(gens)
    for j in range(total):
        ref = _drain_one(gens[j % k])
        if ref is None:
            raise RuntimeError(
                f"stage stream {j % k} ended early at output {j}/{total}")
        yield ref


def _consume_completion_order(gens) -> Iterator[Any]:
    """Completion-order yield via ``wait_any``: whichever member has a
    block buffered is drained first, so a straggler never stalls the
    stream."""
    from ray_tpu_torch.core.streaming import wait_any
    pending = list(gens)
    while pending:
        ready, _ = wait_any(pending, timeout=600.0)
        if not ready:
            raise TimeoutError("fused stage made no progress in 600s")
        for g in ready:
            burst = g.ready_refs()
            if burst:
                yield from burst
            else:
                _drain_one(g, timeout=0.1)  # EOF cleanup / typed error
        pending = [g for g in pending if not g.is_finished()]


# ------------------------------------------------- staged baseline
def _run_fused_stage(items: Iterator[Any], items_are_refs: bool,
                     stage: List[OneToOneOp], ctx: DataContext
                     ) -> Iterator[Any]:
    pool_size = stage[0].actor_pool_size
    stage_cpus = max((op.num_cpus or 1.0) for op in stage)
    if pool_size is None:
        fns = [op.fn for op in stage]
        yield from _window_map(
            items, lambda item: _remote_apply(fns, item, stage_cpus), ctx)
        return
    # Actor-pool stage: round-robin blocks over a pool of stage actors.
    constructors = [op.fn_constructor for op in stage]
    fns = [op.fn for op in stage]
    actor_cls = ray_tpu_torch.remote(num_cpus=stage_cpus)(_ActorStage)
    actors = [actor_cls.remote(constructors) for _ in range(pool_size)]
    submitted: List[Any] = []
    try:
        i = 0
        window = max(pool_size * 2, ctx.max_tasks_in_flight_per_operator)
        inflight: List[Any] = []
        for item in items:
            actor = actors[i % pool_size]
            i += 1
            ref = actor.apply.remote(fns, item)
            submitted.append(ref)
            inflight.append(ref)
            if len(inflight) >= window:
                yield inflight.pop(0)
        while inflight:
            yield inflight.pop(0)
    finally:
        # Yielded refs may not have been consumed yet — wait for every
        # submitted task to finish (results outlive the actors in the
        # object store) BEFORE tearing the pool down.
        if submitted:
            try:
                ray_tpu_torch.wait(submitted, num_returns=len(submitted),
                             timeout=600)
            except Exception:
                pass
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


def _slice_block(block: Block, n: int) -> Block:
    return BlockAccessor(block).slice(0, n)


def _run_limit(refs: Iterator[Any], n: int) -> Iterator[Any]:
    from ray_tpu_torch.data._internal import shuffle as sh
    remaining = n
    rows_fn = sh._r(sh._rows)
    slice_fn = sh._r(_slice_block)
    for ref in refs:
        if remaining <= 0:
            break
        rows = ray_tpu_torch.get(rows_fn.remote(ref))
        if rows <= remaining:
            remaining -= rows
            yield ref
        else:
            yield slice_fn.remote(ref, remaining)
            remaining = 0
