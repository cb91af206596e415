"""The JAX package's ``tests/data/test_streaming_exec.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): the
generator-fed executor's ordered and unordered parity, its credit
window, a stage worker SIGKILLed mid-stream and replayed exactly once,
the equal split's balance and pipelined counts, prefetching and a
materialize that keeps the producers' refs. Every body is loaded, with
the file's own 10-CPU runtime; the four ``slow`` ones (the chaos soak
among them) run with ``-m slow``."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("data/test_streaming_exec.py"))
