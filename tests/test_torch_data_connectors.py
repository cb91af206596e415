"""The JAX package's ``tests/data/test_connectors.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): SQL reads, one
task and sharded, BigQuery and Mongo through injected clients, the
BigQuery argument check, row-group-split parquet reads and hive-style
partitioned writes. Every body is loaded."""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("data/test_connectors.py"))
globals()["ray_session"] = ray_session
