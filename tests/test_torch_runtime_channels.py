"""The JAX package's ``tests/core/test_channels.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): the
mutable-object channel on its own and across threads, and the compiled
DAG's channel pipeline, its stage errors and its fallback to the RPC
path where two stages share one actor. Every body runs; the cross-thread
body keeps its floor of 2000 hand-offs a second."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {}

globals().update(FIXTURES)
globals().update(load_core_tests("test_channels.py", LEAVE_OUT))
