"""The JAX package's ``tests/serve/test_autoscaling_policy.py`` bodies on the
port's serving runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_engine_stats_surfaces":
        "pokes the JAX engine's private _record_ttft with a stub that "
        "lacks the port's request fields; "
        "test_engine_ttft_ewma_tracks_observations holds the same EWMA "
        "on the port's engine",
}

globals().update(FIXTURES)
globals().update(load_core_tests("serve/test_autoscaling_policy.py", LEAVE_OUT))


def test_engine_ttft_ewma_tracks_observations():
    """The port's twin of ``test_engine_stats_surfaces``: the engine's
    TTFT EWMA (the autoscaler's latency signal) tracks observations."""
    from ray_tpu_torch.core.metric_defs import runtime_metrics
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    class _Req:
        t_submit = 10.0
        t_first_token = 10.25
        rid = 1
        prompt = [1, 2, 3]
        warmup = False
        queue_wait_s = 0.0
        t_enqueue_wall = 0.0
        trace = None

    eng = LLMEngine.__new__(LLMEngine)  # no model build: unit surface
    eng._ttft_ewma = eng._queue_wait_ewma = None
    eng._metrics = runtime_metrics()
    eng._recorder = None
    eng.replica_tag = "t"
    eng._record_ttft(_Req())
    assert eng._ttft_ewma == pytest.approx(0.25)
    _Req.t_first_token = 10.05
    eng._record_ttft(_Req())
    # EWMA: 0.8 * 0.25 + 0.2 * 0.05
    assert eng._ttft_ewma == pytest.approx(0.21)
