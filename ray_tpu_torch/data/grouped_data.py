"""GroupBy + aggregations.

Reference: ``python/ray/data/grouped_data.py`` — hash/sort-partition the
dataset by key, then aggregate per group (count/sum/min/max/mean/std,
``map_groups``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import BlockAccessor, _to_table


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    def _grouped_tables(self):
        """Sort by key, then split contiguous key runs (one pass)."""
        ds = self._ds.sort(self._key)
        merged = BlockAccessor.concat(list(ds.iter_blocks()))
        if merged.num_rows == 0:
            return []
        keys = merged[self._key].to_numpy(zero_copy_only=False)
        bounds = [0] + (np.nonzero(keys[1:] != keys[:-1])[0] + 1).tolist() \
            + [len(keys)]
        return [(keys[bounds[i]], merged.slice(
            bounds[i], bounds[i + 1] - bounds[i]))
            for i in range(len(bounds) - 1)]

    def _agg(self, np_fn, cols: List[str], suffix: str):
        from ray_tpu_torch.data.datasource import from_arrow
        rows = []
        for key_val, table in self._grouped_tables():
            row: Dict[str, Any] = {self._key: key_val}
            use = cols or [c for c in table.column_names
                           if c != self._key]
            for c in use:
                arr = table[c].to_numpy(zero_copy_only=False)
                row[f"{c}{suffix}"] = np_fn(arr)
            rows.append(row)
        return from_arrow(pa.Table.from_pylist(rows))

    def count(self):
        from ray_tpu_torch.data.datasource import from_arrow
        rows = [{self._key: k, "count()": t.num_rows}
                for k, t in self._grouped_tables()]
        return from_arrow(pa.Table.from_pylist(rows))

    def sum(self, on=None):
        return self._agg(np.sum, self._cols(on), "_sum")

    def min(self, on=None):
        return self._agg(np.min, self._cols(on), "_min")

    def max(self, on=None):
        return self._agg(np.max, self._cols(on), "_max")

    def mean(self, on=None):
        return self._agg(np.mean, self._cols(on), "_mean")

    def std(self, on=None):
        return self._agg(lambda a: np.std(a, ddof=1) if len(a) > 1 else 0.0,
                         self._cols(on), "_std")

    def _cols(self, on) -> List[str]:
        if on is None:
            return []
        return [on] if isinstance(on, str) else list(on)

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"):
        from ray_tpu_torch.data.datasource import from_arrow
        outs = []
        for _, table in self._grouped_tables():
            batch = BlockAccessor(table).to_batch(batch_format)
            outs.append(_to_table(fn(batch)))
        if not outs:
            return from_arrow(pa.table({}))
        return from_arrow(BlockAccessor.concat(outs))
