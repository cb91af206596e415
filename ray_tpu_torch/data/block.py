"""Blocks: the unit of data movement — Arrow tables in the object store.

Reference: ``python/ray/data/block.py`` (+
``_internal/arrow_block.py``) — a Dataset is a list of object-store
references to blocks; each block is a ``pyarrow.Table``. BlockAccessor
converts between Arrow, pandas, numpy-dict and row-dict views. The numpy
view is the hand-off to the card: contiguous host arrays that a train
worker moves with one ``torch.as_tensor(...).to(device)``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import pyarrow as pa

Block = pa.Table
# What user callables may return from map_batches: arrow, pandas,
# dict-of-numpy, or list of row dicts.
DataBatch = Union["pa.Table", "Dict[str, np.ndarray]", "Any"]


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[pa.Schema]

    @staticmethod
    def of(block: Block) -> "BlockMetadata":
        return BlockMetadata(block.num_rows, block.nbytes, block.schema)


def _host_array(v) -> np.ndarray:
    """A batch column as a host numpy array. A ``torch.Tensor``, on the
    CPU or the card, comes to the host with ``.detach().cpu().numpy()``,
    as ``np.asarray`` brings a device array to the host; a dtype numpy
    cannot hold (bf16) is refused, as Arrow refuses ml_dtypes' bfloat16."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        try:
            return v.detach().cpu().numpy()
        except TypeError as e:
            raise pa.ArrowNotImplementedError(
                f"Unsupported torch dtype {v.dtype}") from e
    return np.asarray(v)


def _to_table(data: DataBatch) -> pa.Table:
    """Normalize any supported batch format into an Arrow table."""
    if isinstance(data, pa.Table):
        return data
    if data is None:
        return pa.table({})
    try:
        import pandas as pd
        if isinstance(data, pd.DataFrame):
            return pa.Table.from_pandas(data, preserve_index=False)
    except ImportError:
        pass
    if isinstance(data, dict):
        import json
        arrays, fields = [], []
        for k, v in data.items():
            arr = _host_array(v)
            if arr.ndim > 1:
                # Tensor columns: fixed-size lists + shape metadata so
                # to_numpy() reconstructs (n, *shape) contiguously
                # (minimal analog of the reference's ArrowTensorArray).
                flat = np.ascontiguousarray(
                    arr.reshape(arr.shape[0], -1))
                col = pa.FixedSizeListArray.from_arrays(
                    pa.array(flat.ravel()), flat.shape[1])
                field = pa.field(
                    k, col.type,
                    metadata={b"tensor_shape": json.dumps(
                        list(arr.shape[1:])).encode()})
            else:
                col = pa.array(arr)
                field = pa.field(k, col.type)
            arrays.append(col)
            fields.append(field)
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
    if isinstance(data, list):
        if not data:
            return pa.table({})
        if isinstance(data[0], dict):
            return pa.Table.from_pylist(data)
        return pa.table({"item": pa.array(data)})
    raise TypeError(f"Unsupported batch type: {type(data)}")


class BlockAccessor:
    """View/convert one block (reference ``BlockAccessor``)."""

    def __init__(self, block: Block):
        self._table = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- views --------------------------------------------------------
    def to_arrow(self) -> pa.Table:
        return self._table

    def to_pandas(self):
        return self._table.to_pandas()

    def to_numpy(self, columns: Optional[List[str]] = None
                 ) -> Dict[str, np.ndarray]:
        import json
        cols = columns or self._table.column_names
        out = {}
        for name in cols:
            col = self._table[name]
            field = self._table.schema.field(name)
            if pa.types.is_fixed_size_list(field.type):
                chunk = col.combine_chunks()
                flat = chunk.flatten().to_numpy(zero_copy_only=False)
                shape: List[int] = [len(chunk), field.type.list_size]
                meta = field.metadata or {}
                if b"tensor_shape" in meta:
                    shape = [len(chunk)] + json.loads(
                        meta[b"tensor_shape"].decode())
                out[name] = flat.reshape(shape)
                continue
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                out[name] = np.asarray(col.to_pylist())
        return out

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self._table
        raise ValueError(f"Unknown batch_format: {batch_format}")

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for row in self._table.to_pylist():
            yield row

    # -- ops ----------------------------------------------------------
    def num_rows(self) -> int:
        return self._table.num_rows

    def size_bytes(self) -> int:
        return self._table.nbytes

    def schema(self) -> Optional[pa.Schema]:
        return self._table.schema

    def slice(self, start: int, end: int) -> Block:
        return self._table.slice(start, end - start)

    def take(self, indices) -> Block:
        return self._table.take(pa.array(indices))

    def select(self, columns: List[str]) -> Block:
        return self._table.select(columns)

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        tables = [b for b in blocks if b.num_rows > 0]
        if not tables:
            return blocks[0] if blocks else pa.table({})
        return pa.concat_tables(tables, promote_options="default")

    @staticmethod
    def builder() -> "BlockBuilder":
        return BlockBuilder()


class BlockBuilder:
    def __init__(self):
        self._rows: List[Dict[str, Any]] = []
        self._tables: List[pa.Table] = []

    def add(self, row: Dict[str, Any]) -> None:
        self._rows.append(row)

    def add_block(self, block: Block) -> None:
        self._flush_rows()
        self._tables.append(block)

    def _flush_rows(self) -> None:
        if self._rows:
            self._tables.append(pa.Table.from_pylist(self._rows))
            self._rows = []

    def num_rows(self) -> int:
        return sum(t.num_rows for t in self._tables) + len(self._rows)

    def build(self) -> Block:
        self._flush_rows()
        if not self._tables:
            return pa.table({})
        return BlockAccessor.concat(self._tables)
