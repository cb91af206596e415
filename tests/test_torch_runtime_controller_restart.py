"""The JAX package's ``tests/core/test_controller_restart.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {}

globals().update(FIXTURES)
globals().update(load_core_tests("test_controller_restart.py", LEAVE_OUT))


# ------------------------------------------------- port-only: KV retransmit
import threading  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

#: the RPC timeout of the runtime below: what a lost KV read waits
RPC_TIMEOUT_S = 10.0


@pytest.fixture
def severable_driver(monkeypatch):
    """A runtime whose driver carries a chaos injector that injects no
    fault by itself (every probability 0), so that a test can cut the
    driver's controller link by hand; RPCs time out after RPC_TIMEOUT_S."""
    import ray_tpu_torch
    from ray_tpu_torch.core.global_state import global_worker
    monkeypatch.setenv("RAY_TPU_TORCH_CHAOS_SEED", "0")
    ray_tpu_torch.init(num_cpus=1, _num_initial_workers=0,
                       _system_config={"rpc_timeout_s": RPC_TIMEOUT_S})
    yield global_worker()
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("retransmit", [True, False],
                         ids=["kv_op_reliable", "kv_op_not_reliable"])
def test_kv_read_lost_across_controller_restart(severable_driver,
                                                retransmit):
    """A KV read written into the driver's controller link while the link
    is cut is lost; the controller then restarts (a kill -9: the new one
    replays the WAL) and the link heals. With KV_OP in the reliable set
    the read's retransmit reaches the new controller and is answered well
    inside the RPC timeout; without it the caller waits the whole
    timeout, as the restart body's first read after the restart did when
    it found nothing within its 30 s."""
    from ray_tpu_torch.core import protocol as P
    from ray_tpu_torch.core.chaos import ChaosMonkey
    from ray_tpu_torch.exceptions import RpcTimeoutError
    w = severable_driver
    w.kv_put(b"persist-key", b"persist-value", ns="testns")
    if not retransmit:
        w._reliable._types = w._reliable._types - {P.KV_OP}
    out = {}

    def read():
        t0 = time.monotonic()
        try:
            out["value"] = w.kv_get(b"persist-key", ns="testns")
        except RpcTimeoutError as e:
            out["error"] = e
        out["s"] = time.monotonic() - t0

    w._chaos.sever(None)
    reader = threading.Thread(target=read)
    reader.start()
    time.sleep(0.5)              # the read is written into the cut link
    ChaosMonkey(0).restart_controller()
    w._chaos.heal()
    reader.join(3 * RPC_TIMEOUT_S)
    assert not reader.is_alive()
    assert w._chaos.stats[("sever", "KVO")] >= 1
    if retransmit:
        assert out.get("value") == b"persist-value", out
        assert out["s"] < RPC_TIMEOUT_S / 2, out
    else:
        assert isinstance(out.get("error"), RpcTimeoutError), out
        assert out["s"] >= RPC_TIMEOUT_S, out
