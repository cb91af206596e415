"""The JAX package's ``tests/dashboard`` bodies on the port (loaded by
``tests/test_torch_runtime_loader.py``): jobs submitted, polled, logged
and stopped through ``JobSubmissionClient`` and the dashboard's REST
routes, the priority and elastic hints exported to the driver, the
arbiter route's 404, the cluster status and the web UI's state routes,
and the per-node process feed and the profile route (``slow``).

Every body runs. The JSON the port's dashboard serves for a job equals
the JAX package's for the same job records (fields and status sequence;
times and ids excluded): ``test_job_records_match_the_jax_dashboard``.
"""

import json
import os
import time
import urllib.request

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("dashboard/test_job_submission.py"))
_agents = load_core_tests("dashboard/test_node_agents.py")
globals().update({k: v for k, v in _agents.items() if k.startswith("test_")})

#: what differs between two runs of one job, and so is not compared
VOLATILE = ("submission_id", "start_time", "end_time")


def _job_records(pkg):
    """On a fresh runtime of ``pkg``: three jobs (one that succeeds with
    metadata, priority and an env var, one that fails, one stopped while
    it runs) through the package's own client, each job's record and
    the status sequence seen while polling; then the list route."""
    from importlib import import_module
    subm = import_module(pkg.__name__ + ".job_submission")
    info = pkg.init(num_cpus=2, _num_initial_workers=1)
    try:
        with open(os.path.join(info["session_dir"], "dashboard.json")) as f:
            addr = json.load(f)["address"]
        client = subm.JobSubmissionClient(addr)
        out = {}
        for name, kw in (
                ("ok", dict(entrypoint="python -c \"print('hi')\"",
                            metadata={"team": "gpu"}, priority="high",
                            runtime_env={"env_vars": {"X": "1"}})),
                ("fail", dict(entrypoint="python -c 'raise SystemExit(3)'")),
                ("stop", dict(entrypoint="sleep 600", elastic=True))):
            jid = client.submit_job(**kw)
            seen = []
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                s = client.get_job_status(jid)
                if not seen or seen[-1] != s:
                    seen.append(s)
                if name == "stop" and s == "RUNNING":
                    assert client.stop_job(jid) is True
                if s in subm.JobStatus.TERMINAL:
                    break
                time.sleep(0.05)
            rec = client.get_job_info(jid)
            out[name] = {"record": {k: v for k, v in rec.items()
                                    if k not in VOLATILE},
                         "statuses": [x for x in seen if x != "PENDING"],
                         "times": rec["start_time"] <= rec["end_time"]}
        with urllib.request.urlopen(addr + "/api/jobs/", timeout=10) as r:
            out["listed"] = sorted(
                (j["entrypoint"], j["status"]) for j in json.load(r))
        return out
    finally:
        pkg.shutdown()


def test_job_records_match_the_jax_dashboard():
    import ray_tpu
    import ray_tpu_torch
    want = _job_records(ray_tpu)
    got = _job_records(ray_tpu_torch)
    assert got == want
    assert [got[k]["record"]["status"] for k in ("ok", "fail", "stop")] \
        == ["SUCCEEDED", "FAILED", "STOPPED"]
    assert got["ok"]["statuses"] == ["RUNNING", "SUCCEEDED"]
    assert got["ok"]["record"]["runtime_env"] == {}   # env_vars withheld
