"""ray_tpu_torch.data: streaming distributed datasets, the port of
``ray_tpu/data/`` (reference: ``python/ray/data/``).

Public surface mirrors ``ray.data``: ``range``/``from_*``/``read_*``
constructors, the lazy ``Dataset`` with fused streaming execution, and
``DataContext``.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import (
    ActorPoolStrategy, Dataset, MaterializedDataset)
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.datasource import (
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,
    range_tensor,
    read_binary_files,
    read_bigquery,
    read_images,
    read_csv,
    read_json,
    read_mongo,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "ActorPoolStrategy",
    "Block",
    "BlockAccessor",
    "DataContext",
    "DataIterator",
    "Dataset",
    "MaterializedDataset",
    "from_arrow",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "from_torch",
    "range",
    "range_tensor",
    "read_bigquery",
    "read_binary_files",
    "read_images",
    "read_csv",
    "read_json",
    "read_mongo",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
