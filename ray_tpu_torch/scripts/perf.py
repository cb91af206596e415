"""Core microbenchmark suite.

Reference: ``python/ray/_private/ray_perf.py`` (run as ``ray
microbenchmark``) — the numbers in BASELINE.md §"scalability envelope":
sync/async task throughput, actor call throughput, put throughput.
Prints one JSON line per metric with the reference baseline ratio.

The port's copy of ``ray_tpu/scripts/perf.py``, over the port's runtime.
``BASELINES`` are the reference Ray's published numbers (the upstream
Ray 2.9.2 release log), not a TPU's nor a card's. The PPO phase's local
learner runs on ``device``: the card unless the caller names another
(``main(device="cpu")``, ``cli microbenchmark --device cpu``), raising
where there is no card; its JSON line names the device. The phase runs
only where ``gymnasium`` is installed.
"""

from __future__ import annotations

import functools
import json
import time
from typing import Dict, Optional

import numpy as np

# Reference measured numbers (BASELINE.md, release_logs/2.9.2)
BASELINES = {
    "tasks_sync_per_s": 1046.0,
    "tasks_async_per_s": 8159.0,
    "multi_client_tasks_async_per_s": 26697.0,
    "actor_calls_sync_per_s": 2138.0,
    "actor_calls_async_per_s": 9183.0,
    "put_gib_per_s": 19.5,
    "multi_client_put_gib_per_s": 33.6,
}


_MULTI_CLIENT_SRC = """
import sys, time, os
sys.path.insert(0, {repo!r})
import ray_tpu_torch
from ray_tpu_torch.core.global_state import global_worker
ray_tpu_torch.init(address={session!r}, log_to_driver=False)
mode = {mode!r}

def barrier(name, n):
    # All clients finish booting (python + numpy imports burn whole
    # seconds of the shared core) BEFORE any client starts its timed
    # section — otherwise client A times its work against client B's
    # interpreter startup. The reference's multi-client ray_perf phases
    # get this isolation by aggregating steady-state rates.
    w = global_worker()
    me = w.worker_id.hex().encode()
    w.kv_put(b"perfbar:" + name + b":" + me, b"1", ns="perf")
    deadline = time.monotonic() + 60
    while len(w.kv_keys(b"perfbar:" + name, ns="perf")) < n:
        if time.monotonic() > deadline:
            break
        time.sleep(0.05)

if mode == "tasks":
    @ray_tpu_torch.remote
    def nop():
        return b"ok"
    ray_tpu_torch.get([nop.remote() for _ in range(100)])
    barrier(b"tasks", {clients})
    t0 = time.perf_counter()
    ray_tpu_torch.get([nop.remote() for _ in range({n})])
    print("RESULT", {n} / (time.perf_counter() - t0))
else:
    import numpy as np
    data = np.random.default_rng(0).integers(
        0, 255, size=({mb} << 20,), dtype=np.uint8)
    for _ in range(3):
        ray_tpu_torch.put(data)
    barrier(b"put", {clients})
    t0 = time.perf_counter()
    for _ in range({iters}):
        ray_tpu_torch.put(data)
    print("RESULT", ({mb} * {iters} / 1024.0) / (time.perf_counter() - t0))
ray_tpu_torch.shutdown()
"""


def _run_clients(ray_tpu_torch, mode: str, num_clients: int, **fmt) -> float:
    """Aggregate throughput of N driver processes attached to this
    cluster (reference: multi_client_* phases of ray_perf.py run 4+
    drivers against one cluster)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ray_tpu_torch.core.global_state import global_worker
    src = _MULTI_CLIENT_SRC.format(
        repo=repo, session=global_worker().session_dir,
        mode=mode, clients=num_clients, **fmt)
    procs = [subprocess.Popen(
        [sys.executable, "-c", src], stdout=subprocess.PIPE, text=True,
        env={**os.environ, "RAY_TPU_TORCH_PLATFORM": "cpu"})
        for _ in range(num_clients)]
    total = 0.0
    for p in procs:
        out, _ = p.communicate(timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"client failed rc={p.returncode}")
        vals = [ln.split()[1] for ln in out.splitlines()
                if ln.startswith("RESULT ")]
        total += float(vals[-1])
    return total


def bench_multi_client_tasks(ray_tpu_torch, clients=4, n=1500) -> float:
    return _run_clients(ray_tpu_torch, "tasks", clients, n=n, mb=0, iters=0)


def bench_multi_client_put(ray_tpu_torch, clients=4, mb=32, iters=6) -> float:
    return _run_clients(ray_tpu_torch, "put", clients, n=0, mb=mb, iters=iters)


def bench_rllib_env_steps(ray_tpu_torch, iters=3,
                          device=None) -> Optional[float]:
    """PPO sampling+training throughput in env-steps/s. Pipeline shape
    follows the reference's Atari tuned example
    (``rllib/tuned_examples/ppo/atari-ppo.yaml:1-35``: 10 workers x 5
    envs, train_batch 5000) with the worker count scaled to this host's
    CPUs and CartPole standing in for ALE (not in the image). The
    reference publishes no steps/s number for it, so vs_baseline is
    null — the JSON records the trend across rounds. The learner runs
    on ``device`` (``resolve_device``: the card by default)."""
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        return None
    from ray_tpu_torch.models.transformer import resolve_device
    from ray_tpu_torch.rllib import PPOConfig
    device = resolve_device(device)
    cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 0))
    if cpus < 3:
        # each runner is a 1-CPU actor; with <2 schedulable runners the
        # pipeline shape is meaningless (and actors would never place)
        return None
    n_runners = min(10, cpus - 1)
    config = (PPOConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=n_runners,
                           num_envs_per_env_runner=5)
              .training(train_batch_size=5000, minibatch_size=500,
                        num_epochs=1, lr=3e-4)
              .learners(device=str(device))
              .debugging(seed=0))
    algo = config.build()
    try:
        steps0 = algo.train()["num_env_steps_sampled_lifetime"]
        t0 = time.perf_counter()   # first train() warmed jit + workers
        for _ in range(iters):
            steps = algo.train()["num_env_steps_sampled_lifetime"]
        return (steps - steps0) / (time.perf_counter() - t0)
    finally:
        algo.cleanup()


def bench_tasks_sync(ray_tpu_torch, n=200) -> float:
    @ray_tpu_torch.remote
    def nop():
        return b"ok"

    ray_tpu_torch.get(nop.remote())  # warm worker + export
    t0 = time.perf_counter()
    for _ in range(n):
        ray_tpu_torch.get(nop.remote())
    return n / (time.perf_counter() - t0)


def bench_tasks_async(ray_tpu_torch, n=2000) -> float:
    @ray_tpu_torch.remote
    def nop():
        return b"ok"

    # warm the worker pool + leases to steady state (the reference's
    # ray_perf phases also run against a warm cluster)
    ray_tpu_torch.get([nop.remote() for _ in range(200)])
    t0 = time.perf_counter()
    ray_tpu_torch.get([nop.remote() for _ in range(n)])
    return n / (time.perf_counter() - t0)


def bench_actor_sync(ray_tpu_torch, n=500) -> float:
    @ray_tpu_torch.remote
    class A:
        def m(self):
            return b"ok"

    a = A.remote()
    ray_tpu_torch.get(a.m.remote())
    t0 = time.perf_counter()
    for _ in range(n):
        ray_tpu_torch.get(a.m.remote())
    dt = time.perf_counter() - t0
    ray_tpu_torch.kill(a)
    return n / dt


def bench_actor_async(ray_tpu_torch, n=5000) -> float:
    @ray_tpu_torch.remote
    class A:
        def m(self):
            return b"ok"

    a = A.remote()
    ray_tpu_torch.get([a.m.remote() for _ in range(100)])
    t0 = time.perf_counter()
    ray_tpu_torch.get([a.m.remote() for _ in range(n)])
    dt = time.perf_counter() - t0
    ray_tpu_torch.kill(a)
    return n / dt


def bench_put(ray_tpu_torch, mb=64, iters=8) -> float:
    """Matches the reference's single_client_put_gigabytes workload
    (ray_perf.py puts numpy arrays; pickle-5 ships them out-of-band)."""
    data = np.random.default_rng(0).integers(
        0, 255, size=(mb << 20,), dtype=np.uint8)
    for _ in range(3):
        ray_tpu_torch.put(data)  # warm: fault pages + settle extent recycling
    t0 = time.perf_counter()
    for _ in range(iters):
        ray_tpu_torch.put(data)
    dt = time.perf_counter() - t0
    return (mb * iters / 1024.0) / dt


def bench_put_bytes(ray_tpu_torch, mb=64, iters=8) -> float:
    data = np.random.default_rng(0).bytes(mb << 20)
    for _ in range(3):
        ray_tpu_torch.put(data)  # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        ray_tpu_torch.put(data)
    dt = time.perf_counter() - t0
    return (mb * iters / 1024.0) / dt


def main(device=None) -> Dict[str, float]:
    """Run every phase and print one JSON line a metric; ``device`` is
    the PPO learner's (the card unless named), recorded in its line."""
    import ray_tpu_torch
    from ray_tpu_torch.models.transformer import resolve_device
    started = False
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_cpus=4, _num_initial_workers=2)
        started = True
    @ray_tpu_torch.remote
    def _nop():
        return b"ok"

    def settle():
        # Phase isolation (the reference runs each ray_perf phase as its
        # own process): drain our GC churn, then flush every FIFO the
        # previous phase filled — a nop round-trip through the workers
        # pushes their queued TASK_DONE batches ahead of it, and a
        # controller request drains our own submit/ref-delta stream.
        # Without the drain, phase N's backlog steals phase N+1's core.
        import gc
        gc.collect()
        try:
            ray_tpu_torch.get([_nop.remote() for _ in range(4)], timeout=30)
            from ray_tpu_torch.core.global_state import global_worker
            # FIFO flush: this reply can only arrive after the
            # controller processed everything we sent before it
            global_worker().kv_exists(b"__perf_settle__")
        except Exception:
            pass
        time.sleep(1.0)

    # Cluster warmup: worker subprocesses spend seconds importing on a
    # small host; timing anything against that boot burns the phase
    # (the reference's ray_perf also runs against a warm cluster).
    ray_tpu_torch.get([_nop.remote() for _ in range(200)])
    time.sleep(3.0)
    ray_tpu_torch.get([_nop.remote() for _ in range(100)])

    # Single-client phases FIRST (multi-client forks 4 driver processes
    # whose boot/teardown churn would pollute them), each best-of-2:
    # phases are seconds long and this box's effective CPU swings ~2x.
    results = {}
    for name, fn, reps in (
            ("tasks_sync_per_s", bench_tasks_sync, 3),
            ("tasks_async_per_s", bench_tasks_async, 3),
            ("actor_calls_sync_per_s", bench_actor_sync, 3),
            ("actor_calls_async_per_s", bench_actor_async, 2),
            ("put_gib_per_s", bench_put, 3),
            ("put_bytes_gib_per_s", bench_put_bytes, 2),
            ("multi_client_tasks_async_per_s", bench_multi_client_tasks,
             1),
            ("multi_client_put_gib_per_s", bench_multi_client_put, 1),
            ("rllib_env_steps_per_s", functools.partial(
                bench_rllib_env_steps, device=device), 1),
    ):
        best = None
        for _ in range(reps):
            out = fn(ray_tpu_torch)
            if out is None:
                break
            best = out if best is None else max(best, out)
            settle()
        if best is None:
            continue
        results[name] = best
    for name, value in results.items():
        base = BASELINES.get(name)
        line = {"metric": name, "value": round(value, 1),
                "unit": "GiB/s" if "gib" in name else "1/s",
                "vs_baseline": round(value / base, 3) if base else None}
        if name == "rllib_env_steps_per_s":
            line["device"] = str(resolve_device(device))
        print(json.dumps(line))
    if started:
        ray_tpu_torch.shutdown()
    return results


if __name__ == "__main__":
    main()
