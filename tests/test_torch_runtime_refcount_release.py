"""A return object whose ref a worker dropped is freed (ROADMAP Queue 3
item 16).

A task or an actor method that ``get``s an actor's 4 MB return and
drops the ref must give the 4 MB back while both actors live on. Three
cases, each of which left the object in the controller's table for
good:

- (a) a worker applies its deferred decrements and sends its pending
  count deltas on a timer, idle or busy, as the driver does;
- (b) a ref that crossed processes (the disaggregated router's hand-off,
  passed from the proxy to the decode replica) and was dropped reaches
  the controller's count;
- (c) when a process dies, the controller releases what it still held,
  and the objects it owned that nobody counted: the death of the
  holder, not a decision of the owner.

The JAX package's runtime keeps this fault (standing divergence 15), so
these tests run on the port alone."""

import dataclasses
import os
import time

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.core.global_state import global_worker

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")

PAYLOAD = 1 << 20          # float32 elements: a 4 MB return
#: the controller frees a zero count after its grace window; a worker
#: sends its deltas at least every ``ref_flush_s``: both, with room
FREE_WITHIN_S = 15.0


def payload_objects():
    return [r for r in global_worker().state_query("objects")
            if r["size"] >= 4 * PAYLOAD]


def process_lives(pid: int) -> bool:
    import psutil
    try:
        return psutil.Process(pid).status() != psutil.STATUS_ZOMBIE
    except psutil.NoSuchProcess:
        return False


def wait_freed(what: str) -> None:
    deadline = time.monotonic() + FREE_WITHIN_S
    while payload_objects():
        assert time.monotonic() < deadline, \
            f"{what}: {payload_objects()} still live after " \
            f"{FREE_WITHIN_S} s"
        time.sleep(0.2)


@pytest.fixture
def session(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def make_actors():
    import numpy as np

    @ray_tpu_torch.remote
    class Src:
        def make(self):
            return np.ones(PAYLOAD, np.float32)

    @ray_tpu_torch.remote
    class User:
        def pull(self, src):
            return float(ray_tpu_torch.get(src.make.remote()).sum())

        def keep(self, src):
            self.kept = src.make.remote()
            return float(ray_tpu_torch.get(self.kept).sum())

    @ray_tpu_torch.remote
    def pull(src):
        return float(ray_tpu_torch.get(src.make.remote()).sum())

    return Src, User, pull


@pytest.mark.parametrize("caller", ["task", "actor_method"])
def test_a_dropped_return_is_freed_while_both_actors_live(session, caller):
    """(a): the caller drops the 4 MB return and stays alive."""
    Src, User, pull = make_actors()
    src = Src.remote()
    if caller == "task":
        total = ray_tpu_torch.get(pull.remote(src), timeout=60)
    else:
        user = User.remote()
        total = ray_tpu_torch.get(user.pull.remote(src), timeout=60)
    assert total == PAYLOAD
    wait_freed(caller)
    # the actors still answer: nothing was freed by their death
    assert ray_tpu_torch.get(pull.remote(src), timeout=60) == PAYLOAD


def test_a_killed_holder_releases_the_ref_it_kept(session):
    """(c): an actor keeps the ref it owns; killing it frees the object,
    though the producing actor lives on."""
    Src, User, _ = make_actors()
    src, user = Src.remote(), User.remote()
    assert ray_tpu_torch.get(user.keep.remote(src), timeout=60) == PAYLOAD
    time.sleep(3.0)
    assert len(payload_objects()) == 1, "the kept return was freed"
    ray_tpu_torch.kill(user)
    wait_freed("kept by a killed actor")


def test_an_owner_killed_before_its_deltas_left_frees_its_objects(session):
    """(c): the owner is killed right after it dropped the ref, before
    any count of it can have reached the controller."""
    Src, User, _ = make_actors()
    src, user = Src.remote(), User.remote()
    assert ray_tpu_torch.get(user.pull.remote(src), timeout=60) == PAYLOAD
    ray_tpu_torch.kill(user)
    wait_freed("owned by an actor killed at once")


@pytest.mark.parametrize("producer", ["task", "actor_method"])
def test_a_live_borrower_keeps_a_killed_owners_return(session, tmp_path,
                                                      producer):
    """(c) frees only what nobody counts: an actor hands the driver the
    ref of its own call's 4 MB return and is killed before that call
    ends; the driver's counted ref keeps the object, and its ``get``
    reads it once the call ends."""
    import numpy as np
    gate = str(tmp_path / "gate")

    def made_when_gated():
        while not os.path.exists(gate):
            time.sleep(0.05)
        return np.ones(PAYLOAD, np.float32)

    slow = ray_tpu_torch.remote(made_when_gated)

    @ray_tpu_torch.remote
    class Src:
        def make(self):
            return made_when_gated()

    @ray_tpu_torch.remote
    class Owner:
        def start(self, src):
            # in a list, so the driver gets the ref and not the value
            return os.getpid(), [src.make.remote() if src is not None
                                 else slow.remote()]

    src = Src.remote() if producer == "actor_method" else None
    owner = Owner.remote()
    pid, [ref] = ray_tpu_torch.get(owner.start.remote(src), timeout=60)
    time.sleep(3.0)      # the driver's +1 reaches the controller
    ray_tpu_torch.kill(owner)
    deadline = time.monotonic() + 30
    while process_lives(pid):
        assert time.monotonic() < deadline, "the owner outlived its kill"
        time.sleep(0.1)
    time.sleep(2.0)      # the controller has seen its worker exit
    open(gate, "w").close()
    # the call ends and is recorded while nothing waits on it: only the
    # driver's count can keep its return
    time.sleep(3.0)
    got = ray_tpu_torch.get(ref, timeout=60)
    assert got.shape == (PAYLOAD,) and float(got.sum()) == PAYLOAD
    del ref, got
    wait_freed("dropped by the driver after its owner died")


def test_s2_leaves_no_hand_off_in_the_store(monkeypatch):
    """(b): S2 at gptj-tiny inside ``chip_smoke.runtime()``, the runtime
    S2-JC1 share on the card: after ``serve.shutdown`` no KV hand-off is
    left in the controller's object table (each is 0.69-0.72 MB here,
    1.248 GB the four at GPT-J-6B width)."""
    import cloudpickle

    import chip_smoke
    import ray_tpu_torch.models as models
    from ray_tpu_torch.models import get_config, init_params
    for name, fn in (("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("memory_allocated", lambda *a: 0),
                     ("mem_get_info", lambda *a: (1 << 34, 1 << 36)),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("device_count", lambda: 1)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(chip_smoke, "check", lambda ok, what: None)
    cfg = dataclasses.replace(get_config("gptj-tiny"), max_seq_len=1024)
    monkeypatch.setattr(models, "get_config", lambda name: cfg)
    cloudpickle.register_pickle_by_value(chip_smoke)
    dev = torch.device("cpu")
    try:
        params = init_params(cfg, seed=0, device=dev, dtype=cfg.dtype)
        server = chip_smoke.phase_server(dev, "cpu", cfg, params, 0)
        with chip_smoke.runtime():
            out = chip_smoke.serve_phases(
                dev, "cpu", 0, server, server,
                chip_smoke.weights_checksum(params), names=("S2",))
            shipped = out["S2"]["kv_ship_bytes"]
            assert shipped > 0
            deadline = time.monotonic() + FREE_WITHIN_S
            while True:
                left = [r for r in global_worker().state_query("objects")
                        if r["size"] >= 100_000]
                if not left or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
    finally:
        cloudpickle.unregister_pickle_by_value(chip_smoke)
    assert left == [], f"{len(left)} hand-off payloads left in the store"
