"""The JAX package's ``tests/util/test_state_metrics_mp.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): the state API,
the metrics' Prometheus export, ``util/multiprocessing.py``'s ``Pool``
and the timeline."""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("util/test_state_metrics_mp.py"))
globals()["ray_session"] = ray_session
