"""``ray_tpu_torch.workflow`` on the CPU: the JAX package's
``tests/dag/test_workflow_events.py`` bodies on the port (loaded by
``tests/test_torch_runtime_loader.py``; the slow one passes with
``-m slow``), and a workflow's ``run``/``resume`` outputs and storage
layout against ``ray_tpu.workflow``'s on the same DAG."""

import numpy as np

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

globals().update(FIXTURES)
globals().update(load_core_tests("dag/test_workflow_events.py"))
globals()["ray_session"] = ray_session


def _workflows(pkg, root):
    """A DAG whose last task fails once (a marker file), run then
    resumed, and a second run of the finished workflow, under
    ``pkg.workflow`` with storage at ``root``: the outputs, statuses and
    every file the storage holds with its contents (pickles loaded)."""
    import json
    import os
    import pickle
    from importlib import import_module
    wf = import_module(pkg.__name__ + ".workflow")
    wf.init_storage(root)
    marker = os.path.join(root, "marker")

    @pkg.remote
    def load(n):
        return np.arange(n, dtype=np.float64)

    @pkg.remote
    def scale(a, k):
        return a * k

    @pkg.remote
    def total(a, b, marker):
        if not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("first attempt")
        return float(a.sum() + b.sum())

    base = load.bind(5)
    dag = total.bind(scale.bind(base, 2.0), scale.bind(base, 3.0), marker)
    out = {}
    try:
        wf.run(dag, workflow_id="w")
    except Exception as e:  # noqa: BLE001 -- the first attempt
        out["first"] = type(e).__name__
    out["status_failed"] = wf.get_status("w")
    out["resumed"] = wf.resume("w")
    out["again"] = wf.run(dag, workflow_id="w")
    out["status"] = wf.get_status("w")
    out["listed"] = wf.list_all()
    files = {}
    for dirpath, _, names in os.walk(os.path.join(root, "w")):
        for n in names:
            rel = os.path.relpath(os.path.join(dirpath, n), root)
            if n == "meta.json":
                with open(os.path.join(dirpath, n)) as f:
                    meta = json.load(f)
                files[rel] = {k: meta[k] for k in ("status", "workflow_id")}
            elif n.endswith(".pkl") and n != "dag.pkl":
                with open(os.path.join(dirpath, n), "rb") as f:
                    v = pickle.load(f)
                files[rel] = v.tolist() if hasattr(v, "tolist") else v
            else:
                files[rel] = None
    out["files"] = files
    wf.delete("w")
    out["after_delete"] = wf.list_all()
    return out


def test_run_resume_and_storage_equal_the_jax_workflows(tmp_path):
    import threading

    import ray_tpu
    import ray_tpu_torch
    got = {}
    for pkg in (ray_tpu, ray_tpu_torch):
        root = str(tmp_path / pkg.__name__)
        own = not pkg.is_initialized()     # a loaded body's module runtime
        if own:
            pkg.init(num_cpus=4, _num_initial_workers=2)
        box = {}
        t = threading.Thread(target=lambda: box.update(
            out=_workflows(pkg, root)), daemon=True)
        try:
            t.start()
            t.join(180)
            assert not t.is_alive(), f"{pkg.__name__}'s workflow hung"
            got[pkg.__name__] = box["out"]
        finally:
            if own:
                pkg.shutdown()
    want = got["ray_tpu"]
    assert want["resumed"] == want["again"] == 5.0 * 10
    assert want["first"] == "TaskError" and want["status"] == "SUCCESSFUL"
    assert got["ray_tpu_torch"] == want
