"""The JAX package's ``tests/data/test_tfrecords_webdataset.py`` bodies
on the port (loaded by ``tests/test_torch_runtime_loader.py``): the
hand-written TFRecord framing and ``Example`` codec (CRC-32C vectors, a
proto round trip, corruption caught), ``read_tfrecords`` with ragged
features, and WebDataset tar shards. Every body is loaded; the one
``slow`` body runs with ``-m slow``."""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("data/test_tfrecords_webdataset.py"))
globals()["ray_session"] = ray_session
