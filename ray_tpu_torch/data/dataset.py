"""Dataset: lazy, streaming, distributed data.

Reference: ``python/ray/data/dataset.py:137`` (``map_batches`` :371,
``iter_batches`` :3640, ``materialize`` :4520, ``streaming_split``).
Blocks are Arrow tables in the object store; transforms are lazy logical
ops executed by the fused streaming executor (``_internal/plan.py``).
This layer is host-side CPU work: ``iter_batches`` yields numpy dicts
sized for one host-to-card copy per step, and ``streaming_split`` feeds
one shard per train worker.
"""

from __future__ import annotations

import functools
import itertools
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Union)

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block, BlockAccessor, BlockMetadata, _to_table)
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data._internal.plan import (
    AllToAllOp, ExchangeOp, ExecutionPlan, InputDataOp, LimitOp,
    OneToOneOp, ReadOp,
    UnionOp, execute_streaming)
from ray_tpu_torch.data._internal import shuffle as shuffle_mod


class ActorPoolStrategy:
    """compute= for map_batches (reference ``ActorPoolStrategy``)."""

    def __init__(self, size: Optional[int] = None,
                 min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.size = size or max_size or min_size or 2


def _batched(table: pa.Table, batch_size: Optional[int]
             ) -> Iterator[pa.Table]:
    if batch_size is None or table.num_rows <= batch_size:
        yield table
        return
    for start in range(0, table.num_rows, batch_size):
        yield table.slice(start, batch_size)


def _make_map_batches_block_fn(fn, batch_size, batch_format, fn_args,
                               fn_kwargs):
    def block_fn(block: Block, instance=None) -> Block:
        call = instance if instance is not None else fn
        outs = []
        for sub in _batched(block, batch_size):
            batch = BlockAccessor(sub).to_batch(batch_format)
            out = call(batch, *fn_args, **fn_kwargs)
            outs.append(_to_table(out))
        return BlockAccessor.concat(outs)
    return block_fn


class Dataset:
    def __init__(self, plan: ExecutionPlan):
        self._plan = plan

    # ------------------------------------------------------ transforms
    def map_batches(self, fn, *, batch_size: Optional[int] = 1024,
                    batch_format: Optional[str] = None,
                    compute: Optional[ActorPoolStrategy] = None,
                    fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    num_cpus: Optional[float] = None,
                    **_ignored) -> "Dataset":
        """Reference ``dataset.py:371``. ``fn`` maps a batch (numpy dict
        by default) to a batch; a callable CLASS runs on an actor pool
        with per-actor construction."""
        ctx = DataContext.get_current()
        batch_format = batch_format or ctx.default_batch_format
        fn_kwargs = fn_kwargs or {}
        is_class = isinstance(fn, type)
        name = f"MapBatches({getattr(fn, '__name__', 'fn')})"
        if is_class and compute is None:
            compute = ActorPoolStrategy(size=2)
        ctor = None
        if is_class:
            ckw = fn_constructor_kwargs or {}
            cargs = fn_constructor_args
            cls = fn
            ctor = lambda: cls(*cargs, **ckw)  # noqa: E731
            fn = None
        block_fn = _make_map_batches_block_fn(
            fn, batch_size, batch_format, fn_args, fn_kwargs)
        op = OneToOneOp(
            block_fn, name=name,
            actor_pool_size=compute.size if compute else None,
            fn_constructor=ctor,
            num_cpus=num_cpus)
        return Dataset(self._plan.with_op(op))

    def map(self, fn, **kwargs) -> "Dataset":
        def block_fn(block: Block) -> Block:
            rows = [fn(r) for r in BlockAccessor(block).iter_rows()]
            # Empty input: keep the input schema rather than degrading
            # to a zero-column table (the output schema is unknowable
            # without rows, and downstream concat promotes).
            return pa.Table.from_pylist(rows) if rows \
                else block.schema.empty_table()
        return Dataset(self._plan.with_op(
            OneToOneOp(block_fn, name="Map")))

    def flat_map(self, fn, **kwargs) -> "Dataset":
        def block_fn(block: Block) -> Block:
            rows = [o for r in BlockAccessor(block).iter_rows()
                    for o in fn(r)]
            return pa.Table.from_pylist(rows) if rows \
                else block.schema.empty_table()
        return Dataset(self._plan.with_op(
            OneToOneOp(block_fn, name="FlatMap")))

    def filter(self, fn, **kwargs) -> "Dataset":
        def block_fn(block: Block) -> Block:
            rows = [r for r in BlockAccessor(block).iter_rows() if fn(r)]
            return (pa.Table.from_pylist(rows) if rows
                    else block.schema.empty_table())
        return Dataset(self._plan.with_op(
            OneToOneOp(block_fn, name="Filter")))

    def select_columns(self, cols: List[str], **kwargs) -> "Dataset":
        return Dataset(self._plan.with_op(OneToOneOp(
            lambda b: BlockAccessor(b).select(cols), name="Select")))

    def drop_columns(self, cols: List[str], **kwargs) -> "Dataset":
        def block_fn(b: Block) -> Block:
            keep = [c for c in b.column_names if c not in cols]
            return BlockAccessor(b).select(keep)
        return Dataset(self._plan.with_op(OneToOneOp(block_fn, name="Drop")))

    def add_column(self, name: str, fn, **kwargs) -> "Dataset":
        def block_fn(b: Block) -> Block:
            df = BlockAccessor(b).to_pandas()
            df[name] = fn(df)
            return _to_table(df)
        return Dataset(self._plan.with_op(
            OneToOneOp(block_fn, name="AddColumn")))

    def rename_columns(self, mapping: Dict[str, str], **kwargs) -> "Dataset":
        def block_fn(b: Block) -> Block:
            return b.rename_columns(
                [mapping.get(c, c) for c in b.column_names])
        return Dataset(self._plan.with_op(
            OneToOneOp(block_fn, name="Rename")))

    # --------------------------------------------------- all-to-all
    # pipelined exchanges (reference: planner/exchange/ fed by the
    # streaming executor): map-side tasks start as upstream blocks
    # materialize instead of after a materialize-all barrier
    def repartition(self, num_blocks: int, **kwargs) -> "Dataset":
        return Dataset(self._plan.with_op(ExchangeOp(
            lambda it, hint: shuffle_mod.streaming_repartition(
                it, num_blocks),
            name=f"Repartition({num_blocks})", out_count=num_blocks)))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None,
                       **kwargs) -> "Dataset":
        return Dataset(self._plan.with_op(ExchangeOp(
            lambda it, hint: shuffle_mod.streaming_random_shuffle(
                it, seed=seed, num_blocks=num_blocks, count_hint=hint),
            name="RandomShuffle")))

    def sort(self, key: str, descending: bool = False, **kwargs
             ) -> "Dataset":
        return Dataset(self._plan.with_op(ExchangeOp(
            lambda it, hint: shuffle_mod.streaming_sort(
                it, key, descending),
            name=f"Sort({key})")))

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._plan.with_op(LimitOp(n)))

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(self._plan.with_op(
            UnionOp([o._plan for o in others])))

    def zip(self, other: "Dataset") -> "Dataset":
        """Reference ``ZipOperator``: column-wise join by row position."""
        other_plan = other._plan

        def do_zip(refs: List[Any]) -> List[Any]:
            counts = ray_tpu_torch.get(
                [shuffle_mod._r(shuffle_mod._rows).remote(r)
                 for r in refs])
            other_refs = shuffle_mod.repartition_to_counts(
                list(execute_streaming(other_plan)), counts)
            return [shuffle_mod._r(_zip_blocks).remote(a, b)
                    for a, b in zip(refs, other_refs)]
        return Dataset(self._plan.with_op(AllToAllOp(do_zip, name="Zip")))

    def groupby(self, key: str) -> "GroupedData":
        from ray_tpu_torch.data.grouped_data import GroupedData
        return GroupedData(self, key)

    # --------------------------------------------------- consumption
    def iter_block_refs(self) -> Iterator[Any]:
        yield from execute_streaming(self._plan)

    def iter_blocks(self) -> Iterator[Block]:
        for ref in self.iter_block_refs():
            yield ray_tpu_torch.get(ref)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = None,
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     **_ignored) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import iter_batches_over_blocks
        batch_format = batch_format or \
            DataContext.get_current().default_batch_format
        yield from iter_batches_over_blocks(
            self.iter_blocks(), batch_size, batch_format, drop_last,
            local_shuffle_buffer_size, local_shuffle_seed)

    def iter_torch_batches(self, **kwargs) -> Iterator[Any]:
        kwargs["batch_format"] = "numpy"
        for batch in self.iter_batches(**kwargs):
            import torch
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    def take(self, limit: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20,
                   batch_format: Optional[str] = None) -> Any:
        it = self.iter_batches(batch_size=batch_size,
                               batch_format=batch_format)
        return next(it)

    def count(self) -> int:
        refs = list(self.iter_block_refs())
        rows_fn = shuffle_mod._r(shuffle_mod._rows)
        return sum(ray_tpu_torch.get([rows_fn.remote(r) for r in refs]))

    def schema(self) -> Optional[pa.Schema]:
        last = None
        for block in self.iter_blocks():
            if block.schema is not None and len(block.schema.names):
                if block.num_rows > 0:
                    return block.schema
                last = block.schema
        return last

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def num_blocks(self) -> int:
        n = self._plan.source_len()
        for op in self._plan.ops:
            if isinstance(op, ExchangeOp) and op.out_count is not None:
                n = op.out_count
        return n

    def size_bytes(self) -> int:
        return sum(b.nbytes for b in self.iter_blocks())

    # -- aggregates ---------------------------------------------------
    def _agg(self, col: str, np_fn) -> Any:
        vals = [np_fn(BlockAccessor(b).to_numpy([col])[col])
                for b in self.iter_blocks() if b.num_rows > 0]
        return np_fn(np.asarray(vals)) if vals else None

    def sum(self, col: str) -> Any:
        vals = [np.sum(BlockAccessor(b).to_numpy([col])[col])
                for b in self.iter_blocks() if b.num_rows > 0]
        return float(np.sum(vals)) if vals else None

    def min(self, col: str) -> Any:
        return self._agg(col, np.min)

    def max(self, col: str) -> Any:
        return self._agg(col, np.max)

    def mean(self, col: str) -> Any:
        total, n = 0.0, 0
        for b in self.iter_blocks():
            if b.num_rows:
                arr = BlockAccessor(b).to_numpy([col])[col]
                total += float(np.sum(arr))
                n += len(arr)
        return total / n if n else None

    def std(self, col: str) -> Any:
        arrs = [BlockAccessor(b).to_numpy([col])[col]
                for b in self.iter_blocks() if b.num_rows]
        if not arrs:
            return None
        rows = np.concatenate(arrs)
        return float(np.std(rows, ddof=1)) if len(rows) > 1 else 0.0

    def unique(self, col: str) -> List[Any]:
        seen = set()
        for b in self.iter_blocks():
            seen.update(BlockAccessor(b).to_numpy([col])[col].tolist())
        return sorted(seen)

    # -- materialization / split --------------------------------------
    def materialize(self) -> "MaterializedDataset":
        refs = list(self.iter_block_refs())
        return MaterializedDataset(
            ExecutionPlan(InputDataOp(refs)))

    def split(self, n: int, *, equal: bool = False,
              locality_hints=None) -> List["MaterializedDataset"]:
        refs = list(self.iter_block_refs())
        if equal:
            refs = shuffle_mod.repartition(
                refs, max(n, (len(refs) // n) * n) if len(refs) >= n
                else n)
        shards: List[List[Any]] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)
        return [MaterializedDataset(ExecutionPlan(InputDataOp(s)))
                for s in shards]

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> List["DataIterator"]:
        """Per-worker shard iterators (reference ``OutputSplitter`` /
        ``streaming_split``) — feeds Train workers."""
        from ray_tpu_torch.data.iterator import make_streaming_shards
        return make_streaming_shards(self, n, equal=equal)

    def to_pandas(self):
        import pandas as pd
        blocks = list(self.iter_blocks())
        if not blocks:
            return pd.DataFrame()
        return BlockAccessor.concat(blocks).to_pandas()

    # -- writes -------------------------------------------------------
    def write_parquet(self, path: str,
                      partition_cols=None, **kwargs) -> None:
        from ray_tpu_torch.data.datasource import write_blocks
        write_blocks(self, path, "parquet",
                     partition_cols=partition_cols)

    def write_csv(self, path: str, **kwargs) -> None:
        from ray_tpu_torch.data.datasource import write_blocks
        write_blocks(self, path, "csv")

    def write_json(self, path: str, **kwargs) -> None:
        from ray_tpu_torch.data.datasource import write_blocks
        write_blocks(self, path, "json")

    # -- misc ---------------------------------------------------------
    def stats(self) -> str:
        return repr(self._plan)

    def __repr__(self):
        return f"Dataset(plan={self._plan!r})"


class MaterializedDataset(Dataset):
    """Fully-executed dataset pinned in the object store
    (reference ``MaterializedDataset``)."""

    @property
    def block_refs(self) -> List[Any]:
        return self._plan.source.block_refs


def _zip_blocks(a: Block, b: Block) -> Block:
    cols = {name: a[name] for name in a.column_names}
    for name in b.column_names:
        out_name = name if name not in cols else f"{name}_1"
        cols[out_name] = b[name]
    return pa.table(cols)
