"""The JAX package's ``tests/core/test_events.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

import json

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_recorder_hot_path_overhead":
        "a load-sensitive timing floor that fails in whole runs of the "
        "JAX package under xdist (ROADMAP Queue 3)",
    "test_timeline_golden_file":
        "the golden file names the JAX package as the trace's source; "
        "test_timeline_golden_file_names_the_port below holds the rest",
}

_core = load_core_tests("test_events.py", LEAVE_OUT)
globals().update(FIXTURES)
globals().update(_core)


def test_timeline_golden_file_names_the_port():
    """The port's Chrome trace of the synthetic events equals the JAX
    package's golden file, except that it names the port as its
    source."""
    trace = _core["EV"].build_chrome_trace(_core["_synthetic_events"]())
    with open(_core["GOLDEN"]) as f:
        golden = json.load(f)
    assert golden["otherData"]["source"] == "ray_tpu flight recorder"
    golden["otherData"]["source"] = "ray_tpu_torch flight recorder"
    assert json.loads(json.dumps(trace)) == golden
