"""The JAX package's ``tests/serve/test_request_trace.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): the tracer,
store and SLO cases on the port's classes, and the live-fleet legs that
serve ``LLMServer`` through ``serve.run``."""

import os
import threading
import time

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

_ENGINE = ("builds a JAX engine in-process; tests/test_torch_request_trace.py "
           "holds the same case on the port's engine")

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_e2e_slo_watchdog_captures_slow_request_with_waterfall":
        "renders through tools/trace.py's in-process source, which reads "
        "the JAX package's runtime; "
        "test_e2e_slo_watchdog_captures_slow_request_in_the_store holds "
        "the capture through the controller's store, the dashboard's "
        "routes and tools/trace.py against the port's dashboard",
    "test_engine_waterfall_has_six_phases": _ENGINE,
    "test_engine_unsampled_fast_request_ships_zero_spans": _ENGINE,
    "test_queue_wait_is_split_out_of_ttft": _ENGINE,
    "test_future_enqueue_stamp_is_clamped": _ENGINE,
    "test_rlhf_pinned_id_without_verdict_keeps_baseline_sampling": _ENGINE,
    "test_engine_death_ships_failed_span_naming_typed_error": _ENGINE,
    "test_decode_tick_bounds_span_count": _ENGINE,
}

globals().update(FIXTURES)
globals().update(load_core_tests("serve/test_request_trace.py", LEAVE_OUT))


@pytest.mark.slow
def test_e2e_slo_watchdog_captures_slow_request_in_the_store():
    """The port's twin of the JAX e2e SLO body: with 1-in-N sampling
    effectively off, a request queued behind long decodes on a 1-slot
    replica trips the queue SLO and its waterfall (six phases) reaches
    the controller's store, the dashboard's ``/api/v0/requests`` routes
    and ``tools/trace.py --dashboard``, while a fast request inside
    every budget ships nothing (404 from the dashboard)."""
    import json
    import subprocess
    import sys
    import urllib.error
    import urllib.request

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.util.state import get_request_trace

    ray_tpu_torch.shutdown()
    os.environ["RAY_TPU_TORCH_TRACE_SAMPLE_N"] = "1000000000"
    os.environ["RAY_TPU_TORCH_SLO_QUEUE_S"] = "0.02"
    try:
        ray_tpu_torch.init(num_cpus=8, _num_initial_workers=3,
                           ignore_reinit_error=True)
        h = serve.run(serve.deployment(serve.LLMServer).bind(
            model=MODEL_DICT,
            engine={"decode_slots": 1, "kv_block_size": 4,
                    "max_seq_len": 48, "prefill_chunk": 8}))
        # router counter 0 is the one 1-in-N hit even at N=1e9
        list(h.options(stream=True).generate.remote([2, 3, 5], 2))
        slow_rid = "req-e2e-slo-victim00"
        fast_rid = "req-e2e-fast-nosample"
        blockers = [threading.Thread(target=lambda i=i: list(
            h.options(stream=True).generate.remote([1 + i, 1, 1], 40)))
            for i in range(3)]
        for b in blockers:
            b.start()
        time.sleep(0.02)
        toks = list(h.options(stream=True, request_id=slow_rid)
                    .generate.remote([8, 6, 4], 8))
        assert len(toks) == 8
        for b in blockers:
            b.join(timeout=120)
        list(h.options(stream=True, request_id=fast_rid)
             .generate.remote([9, 9, 9], 4))
        w = _store_waterfall(slow_rid)
        assert w is not None, "the SLO watchdog never captured it"
        assert "queue" in (w.get("slo") or {}), w.get("slo")
        phases = {sp["phase"] for sp in w["spans"]}
        assert {RT.QUEUED, RT.ADMITTED, RT.PREFILL, RT.FIRST_TOKEN,
                RT.DECODE, RT.DONE} <= phases
        assert get_request_trace(fast_rid) is None

        info = ray_tpu_torch.api._head
        with open(os.path.join(info.session_dir, "dashboard.json")) as f:
            addr = json.load(f)["address"]
        with urllib.request.urlopen(
                addr + f"/api/v0/requests/{slow_rid}", timeout=10) as r:
            via_http = json.loads(r.read())
        assert via_http["request_id"] == slow_rid
        assert {sp["phase"] for sp in via_http["spans"]} >= phases
        with urllib.request.urlopen(addr + "/api/v0/requests",
                                    timeout=10) as r:
            assert any(row["request_id"] == slow_rid
                       for row in json.loads(r.read())["rows"])
        proc = subprocess.run(
            [sys.executable, "tools/trace.py", slow_rid, "--dashboard",
             addr], capture_output=True, text=True, timeout=60,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                __file__))))
        assert proc.returncode == 0, proc.stderr
        for ph in (RT.QUEUED, RT.ADMITTED, RT.PREFILL, RT.FIRST_TOKEN,
                   RT.DECODE, RT.DONE):
            assert ph in proc.stdout, proc.stdout
        assert "SLO TRIP [queue]" in proc.stdout
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(addr + f"/api/v0/requests/{fast_rid}",
                                   timeout=10)
        assert e.value.code == 404
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TORCH_TRACE_SAMPLE_N", None)
        os.environ.pop("RAY_TPU_TORCH_SLO_QUEUE_S", None)
