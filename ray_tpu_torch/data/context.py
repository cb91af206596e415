"""DataContext: execution knobs (reference:
``python/ray/data/context.py`` — ``DataContext.get_current()``)."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataContext:
    target_max_block_size: int = 128 * 1024 * 1024
    target_min_block_size: int = 1 * 1024 * 1024
    # Streaming backpressure: the consumer-paced credit window. In the
    # generator-fed executor this maps onto the streaming layer's
    # ``generator_backpressure_num_objects`` (split across the stage's
    # generator members), so at most this many output blocks per stage
    # are in flight ahead of consumption; in the ``staged`` fallback it
    # is the per-operator in-order task window it always was.
    max_tasks_in_flight_per_operator: int = 8
    # Default batch format for map_batches/iter_batches.
    default_batch_format: str = "numpy"
    # Parallelism used by read_*/range when not given.
    default_parallelism: int = 8
    use_push_based_shuffle: bool = False
    eager_free: bool = True
    # ------------------------------------------------ streaming executor
    #: "streaming" (default): fused one-to-one stages run as long-lived
    #: generator tasks / actor-pool members consuming their upstream
    #: stream, so stage N+1 starts the moment stage N yields its first
    #: block. "staged": the serialized baseline — per-block tasks with
    #: an in-order submission window and a materialize barrier between
    #: stages (what `bench.py --data` measures streaming against).
    execution_mode: str = "streaming"
    #: yield blocks in submission order (deterministic — what `sort`/
    #: `limit`/`take` assume) instead of completion order. Disable for
    #: order-insensitive consumers (training shards): completion order
    #: is surfaced via ``wait_any`` so one straggler block never stalls
    #: the stream.
    preserve_order: bool = True
    #: generator members per fused task-compute stage (actor-pool stages
    #: use their pool size). None = min(#input blocks, in-flight window).
    streaming_stage_parallelism: Optional[int] = None
    #: `iter_batches` keeps this many resolved blocks ahead of the
    #: consume path (per shard) by default.
    prefetch_batches: int = 2
    #: depth of the pipelined row-count lookahead the equal-split
    #: coordinator keeps in flight (so balancing never stalls a shard).
    split_count_pipeline_depth: int = 4

    _current: "Optional[DataContext]" = None
    _lock = threading.Lock()

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = DataContext()
            return cls._current
