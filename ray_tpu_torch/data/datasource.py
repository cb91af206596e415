"""Read/write APIs: range, from_items/pandas/numpy, parquet/csv/json/
text/tfrecords/binary files.

Reference: ``python/ray/data/read_api.py`` + ``datasource/`` (parquet,
csv, json, range, …). Each read resolves to N zero-arg read tasks (one
per file / range shard); the fused executor runs read+transforms as one
task per block.
"""

from __future__ import annotations

import builtins
import functools
import glob as glob_mod
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import Block, BlockAccessor, _to_table
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset
from ray_tpu_torch.data._internal.plan import ExecutionPlan, InputDataOp, ReadOp


def _make_dataset(tasks: List[Callable[[], Block]], name: str) -> Dataset:
    return Dataset(ExecutionPlan(ReadOp(tasks, name=name)))


def _resolve_paths(paths: Union[str, List[str]], suffixes) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.path.expanduser(p)
        if os.path.isdir(p):
            for suffix in suffixes:
                out.extend(sorted(glob_mod.glob(
                    os.path.join(p, f"**/*{suffix}"), recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    out = [p for p in out if os.path.isfile(p)]
    if not out:
        raise FileNotFoundError(f"No files found for {paths!r}")
    return out


# ------------------------------------------------------------- sources
def range(n: int, *, parallelism: int = -1) -> Dataset:
    """Integers [0, n) in column "id" (reference ``ray.data.range``)."""
    ctx = DataContext.get_current()
    p = parallelism if parallelism > 0 else min(
        ctx.default_parallelism, max(1, n))
    base, extra = divmod(n, p)

    def make_task(start: int, count: int) -> Callable[[], Block]:
        return lambda: pa.table(
            {"id": np.arange(start, start + count, dtype=np.int64)})

    tasks, start = [], 0
    for i in builtins.range(p):
        count = base + (1 if i < extra else 0)
        tasks.append(make_task(start, count))
        start += count
    return _make_dataset(tasks, "Range")


def range_tensor(n: int, *, shape: tuple = (1,),
                 parallelism: int = -1) -> Dataset:
    ds = range(n, parallelism=parallelism)
    size = int(np.prod(shape))

    def to_tensor(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        ids = batch["id"]
        data = np.repeat(ids[:, None], size, axis=1).reshape(
            (len(ids),) + shape)
        return {"data": data}
    return ds.map_batches(to_tensor, batch_format="numpy")


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    ctx = DataContext.get_current()
    p = parallelism if parallelism > 0 else min(
        ctx.default_parallelism, max(1, len(items)))
    chunks = np.array_split(np.arange(len(items)), p)

    def make_task(idx: np.ndarray) -> Callable[[], Block]:
        chunk = [items[i] for i in idx]
        def read() -> Block:
            if chunk and isinstance(chunk[0], dict):
                return pa.Table.from_pylist(chunk)
            return pa.table({"item": pa.array(chunk)})
        return read
    return _make_dataset([make_task(c) for c in chunks if len(c)],
                         "FromItems")


def from_pandas(dfs) -> MaterializedDataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    import ray_tpu_torch
    refs = [ray_tpu_torch.put(_to_table(df)) for df in dfs]
    return MaterializedDataset(ExecutionPlan(InputDataOp(refs)))


def from_numpy(arrays) -> MaterializedDataset:
    if not isinstance(arrays, list):
        arrays = [arrays]
    import ray_tpu_torch
    refs = [ray_tpu_torch.put(_to_table({"data": a})) for a in arrays]
    return MaterializedDataset(ExecutionPlan(InputDataOp(refs)))


def from_arrow(tables) -> MaterializedDataset:
    if not isinstance(tables, list):
        tables = [tables]
    import ray_tpu_torch
    refs = [ray_tpu_torch.put(t) for t in tables]
    return MaterializedDataset(ExecutionPlan(InputDataOp(refs)))


def from_huggingface(hf_dataset) -> Dataset:
    """Zero-copy-ish import of a HuggingFace datasets.Dataset (arrow)."""
    table = hf_dataset.data.table if hasattr(hf_dataset, "data") else None
    if table is None:
        return from_items([dict(r) for r in hf_dataset])
    return from_arrow(table.combine_chunks())


def from_torch(torch_dataset) -> Dataset:
    return from_items([{"item": torch_dataset[i]}
                       for i in builtins.range(len(torch_dataset))])


# --------------------------------------------------------------- files
def _file_read_dataset(paths, suffixes, read_one: Callable[[str], Block],
                       name: str) -> Dataset:
    files = _resolve_paths(paths, suffixes)

    def make_task(path: str) -> Callable[[], Block]:
        return lambda: read_one(path)
    return _make_dataset([make_task(f) for f in files], name)


def _pack_files_by_size(files: List[str],
                        target_bytes: int,
                        size_of: Optional[Callable[[str], int]] = None
                        ) -> List[List[str]]:
    """Block-size targeting (reference: FileBasedDatasource's
    target-block-size file grouping): pack small files into one read
    task until ~target_bytes so a directory of tiny files doesn't
    become thousands of tiny blocks."""
    size_of = size_of or (lambda p: os.path.getsize(p))
    groups: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for f in files:
        s = max(1, size_of(f))
        if cur and cur_bytes + s > target_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(f)
        cur_bytes += s
    if cur:
        groups.append(cur)
    return groups


def _grouped_read_dataset(paths, suffixes,
                          read_group: Callable[[List[str]], Block],
                          name: str,
                          target_bytes: Optional[int] = None,
                          size_of=None) -> Dataset:
    ctx = DataContext.get_current()
    files = _resolve_paths(paths, suffixes)
    groups = _pack_files_by_size(
        files, target_bytes or ctx.target_max_block_size, size_of)

    def make_task(group: List[str]) -> Callable[[], Block]:
        return lambda: read_group(group)
    return _make_dataset([make_task(g) for g in groups], name)


_IMAGE_SUFFIXES = [".png", ".jpg", ".jpeg", ".gif", ".bmp", ".webp",
                   ".tif", ".tiff"]


def read_images(paths, *, size: Optional[tuple] = None,
                mode: Optional[str] = None,
                include_paths: bool = False, **kwargs) -> Dataset:
    """Image files into an ``image`` tensor column (reference:
    ``python/ray/data/datasource/image_datasource.py``). ``size=(h, w)``
    resizes (and is required when source images vary in shape);
    ``mode`` converts (e.g. "RGB", "L"). Files are packed into blocks
    targeting the context block size based on DECODED bytes."""
    from PIL import Image

    def decoded_size(p: str) -> int:
        if size is not None:
            channels = 1 if mode == "L" else 3
            return size[0] * size[1] * channels
        # compressed-on-disk size underestimates decoded; ~10x is a
        # serviceable planning figure for typical jpeg/png
        return os.path.getsize(p) * 10

    def read_group(group: List[str]) -> Block:
        arrays, used_paths = [], []
        for p in group:
            img = Image.open(p)
            if mode is not None:
                img = img.convert(mode)
            if size is not None:
                img = img.resize((size[1], size[0]))
            arrays.append(np.asarray(img))
            used_paths.append(p)
        shapes = {a.shape for a in arrays}
        if len(shapes) > 1:
            raise ValueError(
                f"images have differing shapes {sorted(shapes)}; pass "
                f"size=(h, w) to read_images to resize them")
        cols: Dict[str, Any] = {"image": np.stack(arrays)}
        table = _to_table(cols)
        if include_paths:
            table = table.append_column("path", pa.array(used_paths))
        return table

    return _grouped_read_dataset(paths, _IMAGE_SUFFIXES, read_group,
                                 "ReadImages", size_of=decoded_size)


def read_parquet(paths, *, split_row_groups: bool = True,
                 **kwargs) -> Dataset:
    """Parquet with driver-side metadata prefetch (reference:
    ``datasource/parquet_datasource.py:153`` prefetches file metadata to
    plan fragments): large files split into one read task per batch of
    row groups, so a few big files still parallelize; ``columns=`` /
    ``filters=`` push down into the arrow reader."""
    import pyarrow.parquet as pq
    files = _resolve_paths(paths, [".parquet"])
    target = DataContext.get_current().target_max_block_size
    tasks: List[Callable[[], Block]] = []
    for p in files:
        groups: List[List[int]] = []
        # row-group reads honor only columns=; any other reader kwarg
        # (filters, schema, memory_map, ...) forces the whole-file path
        # so its semantics apply uniformly regardless of file size
        if split_row_groups and not (set(kwargs) - {"columns"}):
            try:
                md = pq.ParquetFile(p).metadata  # footer only
                cur: List[int] = []
                cur_bytes = 0
                for g in builtins.range(md.num_row_groups):
                    sz = md.row_group(g).total_byte_size
                    if cur and cur_bytes + sz > target:
                        groups.append(cur)
                        cur, cur_bytes = [], 0
                    cur.append(g)
                    cur_bytes += sz
                if cur:
                    groups.append(cur)
            except Exception:
                groups = []
        if len(groups) > 1:
            for idx in groups:
                tasks.append(functools.partial(
                    lambda p, idx: pq.ParquetFile(p).read_row_groups(
                        idx, columns=kwargs.get("columns")), p, idx))
        else:
            tasks.append(functools.partial(
                lambda p: pq.read_table(p, **kwargs), p))
    return _make_dataset(tasks, "ReadParquet")


def read_csv(paths, **kwargs) -> Dataset:
    from pyarrow import csv as pacsv
    return _file_read_dataset(
        paths, [".csv"], lambda p: pacsv.read_csv(p, **kwargs), "ReadCSV")


def read_json(paths, **kwargs) -> Dataset:
    from pyarrow import json as pajson
    return _file_read_dataset(
        paths, [".json", ".jsonl"],
        lambda p: pajson.read_json(p, **kwargs), "ReadJSON")


def read_text(paths, **kwargs) -> Dataset:
    def read_group(group: List[str]) -> Block:
        lines: List[str] = []
        for p in group:
            with open(p, "r", errors="replace") as f:
                lines.extend(ln.rstrip("\n") for ln in f)
        return pa.table({"text": pa.array(lines)})
    return _grouped_read_dataset(paths, [".txt"], read_group, "ReadText")


def read_binary_files(paths, *, include_paths: bool = False,
                      **kwargs) -> Dataset:
    def read_group(group: List[str]) -> Block:
        blobs, names = [], []
        for p in group:
            with open(p, "rb") as f:
                blobs.append(f.read())
            names.append(p)
        cols: Dict[str, Any] = {"bytes": pa.array(blobs)}
        if include_paths:
            cols["path"] = pa.array(names)
        return pa.table(cols)
    return _grouped_read_dataset(paths, [""], read_group, "ReadBinary")


def read_numpy(paths, **kwargs) -> Dataset:
    def read_one(p: str) -> Block:
        return _to_table({"data": np.load(p)})
    return _file_read_dataset(paths, [".npy"], read_one, "ReadNumpy")


def read_tfrecords(paths, **kwargs) -> Dataset:
    """TFRecord files of ``tf.train.Example`` protos, WITHOUT tensorflow
    (reference: ``data/datasource/tfrecords_datasource.py`` uses the TF
    reader; here the record framing and the Example proto are decoded by
    hand — the formats are small and stable). Columns become Arrow
    arrays; singleton lists unwrap to scalars like the reference."""
    from ray_tpu_torch.data._internal import tfrecords as tfr

    def read_one(p: str) -> Block:
        rows = [tfr.parse_example(rec) for rec in tfr.read_records(p)]
        if not rows:
            return pa.table({})
        keys = sorted({k for r in rows for k in r})
        cols: Dict[str, list] = {}
        for k in keys:
            vals = [r.get(k) for r in rows]
            # singleton unwrap can mix scalars and lists across records;
            # arrow needs one shape — promote everything to lists if any
            # record carried more than one value
            if any(isinstance(v, list) for v in vals):
                vals = [v if isinstance(v, list)
                        else ([] if v is None else [v]) for v in vals]
            cols[k] = vals
        return pa.table(cols)

    return _file_read_dataset(paths, [".tfrecord", ".tfrecords"],
                              read_one, "ReadTFRecords")


def read_webdataset(paths, **kwargs) -> Dataset:
    """WebDataset tar shards (reference:
    ``data/datasource/webdataset_datasource.py``): files grouped by key
    (basename before the first dot); each group becomes one row with a
    column per extension plus ``__key__``."""
    import tarfile

    def read_one(p: str) -> Block:
        groups: Dict[str, Dict[str, bytes]] = {}
        order: List[str] = []
        with tarfile.open(p) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                # key keeps the directory prefix (webdataset semantics:
                # train/0001.jpg and val/0001.jpg are distinct samples)
                name = member.name
                base = os.path.basename(name)
                if "." not in base:
                    key, ext = name, "bin"
                else:
                    ext = base.split(".", 1)[1]
                    key = name[: len(name) - len(ext) - 1]
                if key not in groups:
                    groups[key] = {}
                    order.append(key)
                groups[key][ext] = tf.extractfile(member).read()
        exts = sorted({e for g in groups.values() for e in g})
        import pyarrow as pa
        cols = {"__key__": order}
        for e in exts:
            cols[e] = [groups[k].get(e) for k in order]
        return pa.table(cols)

    return _file_read_dataset(paths, [".tar"], read_one,
                              "ReadWebDataset")


def read_sql(sql: str, connection_factory: Callable[[], Any], *,
             parallelism: int = 1) -> Dataset:
    """Rows of a SQL query over any DB-API 2.0 connection (reference:
    ``data/datasource/sql_datasource.py`` — connection factory + query;
    shards parallelize via LIMIT/OFFSET exactly like the reference's
    ``_read_stream`` pagination). ``connection_factory`` must be
    picklable (e.g. ``functools.partial(sqlite3.connect, path)``)."""

    def fetch(query: str) -> Block:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(query)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return pa.table({c: [r[i] for r in rows]
                         for i, c in enumerate(cols)})

    if parallelism <= 1:
        return _make_dataset([functools.partial(fetch, sql)], "ReadSQL")
    if "order by" not in sql.lower():
        # LIMIT/OFFSET shards over an unordered query have no stable
        # row assignment: concurrent shards could duplicate/miss rows
        raise ValueError(
            "read_sql with parallelism > 1 requires an ORDER BY in the "
            "query (LIMIT/OFFSET sharding needs a deterministic order)")
    # shard by LIMIT/OFFSET over a deterministic total count (the
    # derived table needs an alias on PostgreSQL/MySQL)
    conn = connection_factory()
    try:
        cur = conn.cursor()
        cur.execute(f"SELECT COUNT(*) FROM ({sql}) AS __rt_count")
        total = int(cur.fetchone()[0])
    finally:
        conn.close()
    per = max(1, -(-total // parallelism))
    tasks = [functools.partial(
        fetch, f"{sql} LIMIT {per} OFFSET {off}")
        for off in builtins.range(0, max(total, 1), per)]
    return _make_dataset(tasks, "ReadSQL")


def read_bigquery(project_id: str, *, query: Optional[str] = None,
                  dataset: Optional[str] = None,
                  client_factory: Optional[Callable[[], Any]] = None
                  ) -> Dataset:
    """BigQuery rows (reference: ``datasource/bigquery_datasource.py``
    over ``google.cloud.bigquery``). The client library is not in the
    hermetic image, so a ``client_factory`` is injectable; without
    one, ``google.cloud.bigquery.Client`` is imported lazily."""
    if query is None and dataset is None:
        raise ValueError("read_bigquery needs query= or dataset= "
                         "('dataset.table')")

    def fetch() -> Block:
        if client_factory is not None:
            client = client_factory()
        else:
            try:
                from google.cloud import bigquery
            except ImportError as e:
                raise ImportError(
                    "google-cloud-bigquery is not installed in this "
                    "image; pass client_factory= to inject a client"
                ) from e
            client = bigquery.Client(project=project_id)
        if query is not None:
            result = client.query(query).result()
        else:
            ds_id, table_id = dataset.split(".", 1)
            result = client.list_rows(f"{project_id}.{ds_id}.{table_id}")
        arrow = result.to_arrow()
        return arrow

    return _make_dataset([fetch], "ReadBigQuery")


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[dict]] = None,
               client_factory: Optional[Callable[[], Any]] = None
               ) -> Dataset:
    """MongoDB documents (reference: ``datasource/mongo_datasource.py``
    over pymongo/pymongoarrow). pymongo is not in the hermetic image, so
    a ``client_factory`` is injectable. Documents become one row each;
    ``_id`` is stringified."""

    def fetch() -> Block:
        if client_factory is not None:
            client = client_factory()
        else:
            try:
                import pymongo
            except ImportError as e:
                raise ImportError(
                    "pymongo is not installed in this image; pass "
                    "client_factory= to inject a client") from e
            client = pymongo.MongoClient(uri)
        coll = client[database][collection]
        docs = list(coll.aggregate(pipeline) if pipeline
                    else coll.find())
        if not docs:
            return pa.table({})
        keys = sorted({k for d in docs for k in d})
        cols = {}
        for k in keys:
            vals = [d.get(k) for d in docs]
            if k == "_id":
                vals = [str(v) for v in vals]
            cols[k] = vals
        return pa.table(cols)

    return _make_dataset([fetch], "ReadMongo")


# --------------------------------------------------------------- write
def write_blocks(ds: Dataset, path: str, fmt: str,
                 partition_cols: Optional[List[str]] = None) -> None:
    os.makedirs(path, exist_ok=True)

    def write_one(block, out: str) -> None:
        if fmt == "parquet":
            import pyarrow.parquet as pq
            pq.write_table(block, out)
        elif fmt == "csv":
            from pyarrow import csv as pacsv
            pacsv.write_csv(block, out)
        elif fmt == "json":
            block.to_pandas().to_json(out, orient="records", lines=True)
        else:
            raise ValueError(fmt)

    for i, block in enumerate(ds.iter_blocks()):
        if block.num_rows == 0:
            continue
        if partition_cols:
            # hive-style partitioned layout (reference:
            # ``datasource/parquet_datasource.py`` partitioned writes:
            # path/key=value/.../part-*.ext, partition columns dropped
            # from the file payload). dropna=False + the hive null
            # bucket: pandas' default dropna would SILENTLY drop every
            # row whose partition value is null.
            df = block.to_pandas()
            for c in partition_cols:
                df[c] = df[c].fillna("__HIVE_DEFAULT_PARTITION__")
            for j, (key, part) in enumerate(
                    df.groupby(partition_cols, sort=True,
                               dropna=False)):
                if not isinstance(key, tuple):
                    key = (key,)
                sub = os.path.join(path, *(
                    f"{c}={v}" for c, v in zip(partition_cols, key)))
                os.makedirs(sub, exist_ok=True)
                payload = pa.Table.from_pandas(
                    part.drop(columns=list(partition_cols)),
                    preserve_index=False)
                write_one(payload, os.path.join(
                    sub, f"part-{i:05d}-{j:03d}.{fmt}"))
            continue
        write_one(block, os.path.join(path, f"part-{i:05d}.{fmt}"))
