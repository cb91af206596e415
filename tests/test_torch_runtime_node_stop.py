"""How the port's node manager stops its workers: a worker whose spawn
was in flight when ``stop()`` took its list is killed as it registers,
and a forked worker's handle counts a zombie as ended, so ``stop()``
waits for nothing that is already gone."""

import subprocess
import sys
import threading

import pytest

from ray_tpu_torch.core.ids import WorkerID
from ray_tpu_torch.core.node import NodeManager, _ForkedWorker

SLEEPER = [sys.executable, "-c", "import time; time.sleep(120)"]


def _bare_node(stopped: bool) -> NodeManager:
    """The worker table of a node manager, and its stop flag."""
    node = NodeManager.__new__(NodeManager)
    node._workers_lock = threading.Lock()
    node.workers, node._worker_started = {}, {}
    node._requested_workers = set()
    node._stopped = threading.Event()
    if stopped:
        node._stopped.set()
    return node


@pytest.mark.parametrize("stopped", [False, True])
def test_a_worker_registered_after_stop_is_killed(stopped):
    node = _bare_node(stopped)
    proc = subprocess.Popen(SLEEPER)
    wid = WorkerID.from_random()
    try:
        node._register_worker(wid, proc, requested=True)
        assert node.workers[wid.binary()] is proc
        assert wid.binary() in node._requested_workers
        assert proc.poll() == (-9 if stopped else None)
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_forked_worker_handle_counts_a_zombie_as_ended():
    # a child of this process stays a zombie until it is reaped: the
    # handle must see it end all the same
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(0.5)"])
    try:
        handle = _ForkedWorker(proc.pid)
        assert handle.poll() is None
        assert handle.wait(timeout=30) == 0
        with open(f"/proc/{proc.pid}/stat") as f:
            assert f.read().rsplit(") ", 1)[-1].split()[0] == "Z"
    finally:
        proc.wait(timeout=10)
