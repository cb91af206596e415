"""The JAX package's ``tests/core/test_metrics_plane.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_reporter_roundtrip_and_drop_oldest_accounting":
        "a load-sensitive timing floor that fails in whole runs of the "
        "JAX package under xdist (ROADMAP Queue 3)",
    "test_e2e_fleet_metrics_three_pids_and_tokens_series":
        "builds a JAX model and reads the dashboard; slow-marked",
}

globals().update(FIXTURES)
globals().update(load_core_tests("test_metrics_plane.py", LEAVE_OUT))
