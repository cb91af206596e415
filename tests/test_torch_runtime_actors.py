"""The JAX package's ``tests/core/test_actors.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {}

globals().update(FIXTURES)
globals().update(load_core_tests("test_actors.py", LEAVE_OUT))
