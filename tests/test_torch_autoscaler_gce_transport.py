"""The JAX package's ``tests/autoscaler/test_gce_transport.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("autoscaler/test_gce_transport.py"))
