"""The JAX package's ``tests/serve/test_admission.py`` bodies on the
port's serving runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {}

globals().update(FIXTURES)
globals().update(load_core_tests("serve/test_admission.py", LEAVE_OUT))


def test_controller_policy_round_trip(serve_session):
    """``test_dashboard_policy_round_trip`` without the dashboard:
    a policy stored on the serve controller (what the dashboard's POST
    calls) reaches a live router with admission enabled, which sheds by
    the new rules; a bad policy is refused without being stored."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.exceptions import AdmissionRejectedError
    from ray_tpu_torch.serve import api as serve_api

    @serve.deployment
    def echo(x):
        return x

    handle = serve.run(echo.bind(), route_prefix="/echo")
    handle.enable_admission()            # default policy: no budgets
    assert handle.remote("ok").result() == "ok"
    controller = serve_api._get_or_create_controller()
    with pytest.raises(Exception, match="unknown admission policy keys"):
        ray_tpu_torch.get(controller.set_admission_policy.remote(
            {"not_a_knob": 1}), timeout=30)
    seq = ray_tpu_torch.get(controller.set_admission_policy.remote(
        {"tenant_budgets": {"acme": 0.0}, "budget_window_s": 5.0}),
        timeout=30)
    assert seq == 1
    got_seq, got = ray_tpu_torch.get(
        controller.get_admission_policy.remote(), timeout=30)
    assert got_seq == 1 and got["tenant_budgets"] == {"acme": 0.0}
    handle._router._last_policy_poll = 0.0
    with pytest.raises(AdmissionRejectedError):
        handle.options(tenant="acme").remote("x").result()
    assert handle.remote("ok").result() == "ok"
