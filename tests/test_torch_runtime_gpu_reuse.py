"""A ``num_gpus=1`` call made after default-shape tasks runs on the
worker that already holds the card, and the node starts no new worker
for it.

Default-shape tasks lease idle workers to the driver for direct
submission. The port's controller keeps a worker that has run a GPU
task out of those leases and prefers it for the next GPU task, so a
later GPU call neither forks a worker nor makes a second CUDA context.
Here the workers stay off the card (``RAY_TPU_TORCH_PLATFORM=cpu``) and
``GPU`` is scheduled as a logical resource."""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import api

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")

DEFAULT_TASKS = 21
LATER_GPU_CALLS = 3


def settled_workers(timeout_s: float = 60.0) -> int:
    """The node's worker count once every worker the controller asked
    it to start has registered (a burst of tasks may leave spawns in
    flight)."""
    deadline = time.monotonic() + timeout_s
    nodes = api._head.controller.nodes.values()
    while any(n.starting_workers for n in nodes):
        assert time.monotonic() < deadline, "a worker never registered"
        time.sleep(0.05)
    return len(api._head.node.workers)


@pytest.fixture
def gpu_session(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_PLATFORM", "cpu")
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield
    ray_tpu_torch.shutdown()


def test_gpu_calls_after_default_tasks_reuse_the_gpu_worker(gpu_session):
    def pid():
        return os.getpid()

    on_card = ray_tpu_torch.remote(num_gpus=1)(pid)
    default = ray_tpu_torch.remote(pid)
    p = ray_tpu_torch.get(on_card.remote(), timeout=120)
    pids = ray_tpu_torch.get([default.remote()
                              for _ in range(DEFAULT_TASKS)], timeout=120)
    assert len(pids) == DEFAULT_TASKS
    workers = settled_workers()
    later = [ray_tpu_torch.get(on_card.remote(), timeout=120)
             for _ in range(LATER_GPU_CALLS)]
    assert later == [p] * LATER_GPU_CALLS
    assert settled_workers() == workers
