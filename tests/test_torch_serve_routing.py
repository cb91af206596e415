"""The JAX package's ``tests/serve/test_routing.py`` bodies on the
port's serving runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {}

globals().update(FIXTURES)
globals().update(load_core_tests("serve/test_routing.py", LEAVE_OUT))
