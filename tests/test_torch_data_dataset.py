"""The JAX package's ``tests/data/test_dataset.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``): ranges, maps,
fusion, columns, repartition, shuffle, sort, limit/union/zip, batches,
aggregates, groupby, actor pools, splits, file round trips and a
dataset streamed into a two-worker ``DataParallelTrainer``. Every body
is loaded; the two ``slow`` ones run with ``-m slow``."""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("data/test_dataset.py"))
globals()["ray_session"] = ray_session
