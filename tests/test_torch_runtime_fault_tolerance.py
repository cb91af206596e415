"""The JAX package's ``tests/core/test_fault_tolerance.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_rollout_stream_midepoch_kill_exactly_once":
        "reads rllib (ROADMAP Queue 1 item 10)",
    "test_mpmd_pipeline_midstage_kill_fails_typed_no_hang":
        "builds a JAX model on the MPMD pipeline (item 9); slow-marked",
    "test_mpmd_pipeline_train_midstage_kill_fails_typed_no_hang":
        "builds a JAX model on the MPMD pipeline (item 9); slow-marked",
}

globals().update(FIXTURES)
globals().update(load_core_tests("test_fault_tolerance.py", LEAVE_OUT))
