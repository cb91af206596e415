"""The JAX package's ``tests/util/test_joblib_logmon_env.py`` bodies on
the port (loaded by ``tests/test_torch_runtime_loader.py``): the joblib
backend of ``util/joblib_backend.py``, the log monitor and runtime
environments."""

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("util/test_joblib_logmon_env.py"))
globals()["ray_session"] = ray_session
