"""``ray_tpu_torch.scripts`` on the CPU: the twins of the JAX package's
slow ``tests/autoscaler/test_slice_e2e.py::test_cli_up_down_round_trip``
and ``::test_head_started_slice_monitor_acquires_for_gang`` on the port's
command line, launcher and head daemon (that file imports ``jax`` and is
not loaded), and ``microbenchmark`` printing one JSON line for each key
of ``perf.BASELINES``."""

import json
import os
import subprocess
import sys
import time

import pytest
import yaml

import ray_tpu_torch
from ray_tpu_torch.core.scheduler import SLICE_LABEL
from ray_tpu_torch.util import placement_group, remove_placement_group

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")


def _slice_of(node_row):
    return (node_row.get("labels") or {}).get(SLICE_LABEL)


def _env():
    env = dict(os.environ)
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_up_down_round_trip(tmp_path):
    """``cli up --config <yaml>`` / ``down`` against the fake slice
    provider in subprocesses: the head daemon and a 2-host slice come
    up, register with slice labels, and tear down cleanly."""
    session = str(tmp_path / "cluster")
    cfg = {
        "cluster_name": "cli-rt",
        "provider": {"type": "fake_slice", "session_dir": session},
        "head_node_type": "head",
        "available_node_types": {"head": {"resources": {"CPU": 1}}},
        "slices": {"pod": {"topology": "2x4", "count": 1,
                           "host_resources": {"CPU": 1}}},
    }
    cfg_path = tmp_path / "cluster.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    env = _env()
    up = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "up", "-y",
         "--config", str(cfg_path)],
        capture_output=True, text=True, timeout=180, env=env,
        cwd=REPO_ROOT)
    assert up.returncode == 0, up.stdout + up.stderr
    out = json.loads(up.stdout.strip().splitlines()[-1])
    assert out["session_dir"] == session
    assert len(out["slices"]) == 1
    sid = out["slices"][0]
    with open(os.path.join(session, "fake_slices.json")) as f:
        assert sid in json.load(f)["slices"]

    ray_tpu_torch.init(address=session)
    try:
        deadline = time.monotonic() + 90
        while True:
            hosts = [n for n in ray_tpu_torch.nodes()
                     if n["alive"] and _slice_of(n) == sid]
            if len(hosts) == 2:
                break
            assert time.monotonic() < deadline, ray_tpu_torch.nodes()
            time.sleep(0.5)
        host_pids = []
        with open(os.path.join(session, "fake_slices.json")) as f:
            for h in json.load(f)["slices"][sid]["hosts"]:
                host_pids.append(h["pid"])
    finally:
        ray_tpu_torch.shutdown()

    down = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "down", "-y",
         "--config", str(cfg_path)],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=REPO_ROOT)
    assert down.returncode == 0, down.stdout + down.stderr
    gone = json.loads(down.stdout.strip().splitlines()[-1])
    assert gone["terminated"] == [sid]
    deadline = time.monotonic() + 30
    for pid in host_pids + [gone["head_pid"]]:
        while True:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            assert time.monotonic() < deadline, f"{pid} survived down"
            time.sleep(0.2)


def test_head_started_slice_monitor_acquires_for_gang(tmp_path):
    """With a ``slices:`` section in the cluster config the HEAD builds
    and polls the SliceManager: a driver's pending SLICE_SPREAD gang
    acquires a whole slice with no manager built by the driver or the
    test (``count: 0``: the slice can only come from the head's
    monitor)."""
    from ray_tpu_torch.autoscaler.launcher import (LocalClusterLauncher,
                                                   validate_cluster_config)
    session = str(tmp_path / "cluster")
    cfg = validate_cluster_config({
        "cluster_name": "head-mon",
        "provider": {"type": "fake_slice", "session_dir": session},
        "head_node_type": "head",
        "available_node_types": {"head": {"resources": {"CPU": 1}}},
        "slices": {"pod": {"topology": "2x4", "count": 0,
                           "host_resources": {"CPU": 1, "hostchip": 4}}},
    })
    launcher = LocalClusterLauncher(cfg)
    out = launcher.up()
    assert out["slices"] == []
    try:
        ray_tpu_torch.init(address=session)
        try:
            pg = placement_group([{"hostchip": 1}] * 2,
                                 strategy="SLICE_SPREAD")
            assert pg.ready(timeout=120), \
                "head-started SliceManager never acquired a slice"
            assert len(set(pg.bundle_nodes)) == 2
            assert pg.slice_id() is not None
            rows = {n["node_id"]: n for n in ray_tpu_torch.nodes()}
            sids = {_slice_of(rows[nb.hex()]) for nb in pg.bundle_nodes}
            assert len(sids) == 1 and None not in sids
            remove_placement_group(pg)
        finally:
            ray_tpu_torch.shutdown()
    finally:
        launcher.down()


def test_microbenchmark_prints_a_json_line_for_each_baseline(
        monkeypatch, capsys):
    """``cli microbenchmark`` (the suite at small counts here; the card's
    script runs it at its defaults) prints one JSON line a metric, one
    for each key of ``BASELINES`` among them, each with its ratio to the
    reference's published number."""
    import functools

    from ray_tpu_torch.scripts import cli, perf
    for name, kw in (("bench_tasks_sync", dict(n=20)),
                     ("bench_tasks_async", dict(n=200)),
                     ("bench_actor_sync", dict(n=50)),
                     ("bench_actor_async", dict(n=200)),
                     ("bench_put", dict(mb=4, iters=2)),
                     ("bench_put_bytes", dict(mb=4, iters=2)),
                     ("bench_multi_client_tasks", dict(clients=2, n=100)),
                     ("bench_multi_client_put", dict(clients=2, mb=2,
                                                     iters=2))):
        monkeypatch.setattr(perf, name,
                            functools.partial(getattr(perf, name), **kw))
    devices = []

    def ppo(r, iters=3, device=None):
        # the phase itself needs gymnasium and a 5000-step batch; here
        # it records the device it was handed and gives a rate
        devices.append(device)
        return 1.0
    monkeypatch.setattr(perf, "bench_rllib_env_steps", ppo)
    monkeypatch.setattr(sys, "argv", ["cli", "microbenchmark", "--device",
                                      "cpu"])
    cli.main()
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"metric"')]
    by_name = {r["metric"]: r for r in lines}
    assert len(by_name) == len(lines)
    assert set(perf.BASELINES) <= set(by_name)
    for name, base in perf.BASELINES.items():
        r = by_name[name]
        assert r["value"] > 0
        # the value is printed to 0.1, the ratio to 0.001 of the
        # unrounded value
        assert r["vs_baseline"] == pytest.approx(
            r["value"] / base, abs=0.05 / base + 5e-4)
    # the PPO learner's device is the one named, and its line says so
    assert devices == ["cpu"]
    assert by_name["rllib_env_steps_per_s"]["device"] == "cpu"
    assert all("device" not in r for r in lines
               if r["metric"] != "rllib_env_steps_per_s")
    assert not ray_tpu_torch.is_initialized()


def test_microbenchmark_ppo_learner_needs_the_card_unless_named(
        monkeypatch):
    """The PPO phase's learner goes on the card by default: with no card
    and no device named it raises before it builds anything, rather than
    measuring on the CPU under the card's name."""
    import types

    import torch

    from ray_tpu_torch.scripts import perf
    monkeypatch.setitem(sys.modules, "gymnasium",
                        types.ModuleType("gymnasium"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class NoRuntime:
        def cluster_resources(self):
            raise AssertionError("the phase went on past its device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf.bench_rllib_env_steps(NoRuntime())
