"""Workflow execution + storage.

Reference: ``python/ray/workflow/api.py`` (run/resume/get_output),
``workflow_storage.py:229`` (checkpointed task results keyed by
workflow_id + task_id), ``task_executor.py:50``. Execution walks the
DAG bottom-up; each FunctionNode gets a deterministic task id from its
topological position, its result is checkpointed after the remote task
finishes, and a cached result short-circuits re-execution on
resume/re-run.

The port's copy of ``ray_tpu/workflow/api.py``, over the port's
``dag/nodes.py``. Storage defaults to ``RAY_TPU_TORCH_WORKFLOW_STORAGE``,
else ``workflows/`` under the port's session root (the temp dir): a
task's output is stored as ``get`` returned it, so a tensor is stored as
a CPU tensor.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag.nodes import DAGNode, FunctionNode, _ExecutionContext

_storage_dir: Optional[str] = None
_async_pool = None

RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"


def init_storage(path: str) -> None:
    global _storage_dir
    _storage_dir = os.path.abspath(os.path.expanduser(path))
    os.makedirs(_storage_dir, exist_ok=True)


def _storage() -> str:
    global _storage_dir
    if _storage_dir is None:
        from ray_tpu_torch.api import session_root
        init_storage(os.environ.get(
            "RAY_TPU_TORCH_WORKFLOW_STORAGE",
            os.path.join(session_root(), "workflows")))
    return _storage_dir


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


class _WorkflowStorage:
    """Reference ``WorkflowStorage`` :229 — per-workflow task results."""

    def __init__(self, workflow_id: str, create: bool = True):
        self.dir = _wf_dir(workflow_id)
        if create:
            os.makedirs(os.path.join(self.dir, "tasks"), exist_ok=True)

    def has(self, task_id: str) -> bool:
        return os.path.exists(self._task_path(task_id))

    def load(self, task_id: str) -> Any:
        with open(self._task_path(task_id), "rb") as f:
            return pickle.load(f)

    def save(self, task_id: str, value: Any) -> None:
        tmp = self._task_path(task_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, self._task_path(task_id))

    def save_dag(self, dag_bytes: bytes) -> None:
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            f.write(dag_bytes)

    def load_dag(self) -> Optional[bytes]:
        p = os.path.join(self.dir, "dag.pkl")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def set_meta(self, **kwargs) -> None:
        meta = self.meta()
        meta.update(kwargs)
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump(meta, f)

    def meta(self) -> Dict[str, Any]:
        p = os.path.join(self.dir, "meta.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def save_output(self, value: Any) -> None:
        with open(os.path.join(self.dir, "output.pkl"), "wb") as f:
            pickle.dump(value, f)

    def load_output(self) -> Any:
        with open(os.path.join(self.dir, "output.pkl"), "rb") as f:
            return pickle.load(f)

    def has_output(self) -> bool:
        return os.path.exists(os.path.join(self.dir, "output.pkl"))

    def _task_path(self, task_id: str) -> str:
        return os.path.join(self.dir, "tasks", f"{task_id}.pkl")


def _task_ids(root: DAGNode) -> Dict[int, str]:
    """Deterministic task ids: depth-first position + function name."""
    ids: Dict[int, str] = {}
    counter = [0]

    def walk(node):
        if not isinstance(node, DAGNode) or id(node) in ids:
            return
        for dep in node._deps():
            walk(dep)
        if isinstance(node, FunctionNode):
            name = getattr(node._fn, "__name__", None) or getattr(
                getattr(node._fn, "_fn", None), "__name__", "task")
            ids[id(node)] = f"{counter[0]:04d}_{name}"
        counter[0] += 1

    walk(root)
    return ids


def _execute_durable(root: DAGNode, storage: _WorkflowStorage,
                     args, kwargs) -> Any:
    """Two phases. Submit: walk bottom-up; checkpointed tasks are seeded
    as values, the rest are submitted immediately with upstream REFS as
    args — independent branches run in parallel, exactly like plain
    ``dag.execute``. Checkpoint: persist each task's output in
    completion order, so everything that finished before a failure is
    durable for ``resume``."""
    from ray_tpu_torch.dag.nodes import _resolve
    ids = _task_ids(root)
    ctx = _ExecutionContext(args, kwargs)
    submitted = {}  # ref -> (task_id, cache_key)

    def visit(node):
        if not isinstance(node, DAGNode):
            return
        for dep in node._deps():
            visit(dep)
        if isinstance(node, FunctionNode) and id(node) not in ctx.cache:
            task_id = ids[id(node)]
            if storage.has(task_id):
                ctx.cache[id(node)] = storage.load(task_id)
            else:
                ref = _resolve(node, ctx)  # submit; args may be refs
                submitted[ref] = (task_id, id(node))

    visit(root)
    first_error: Optional[BaseException] = None
    pending = list(submitted)
    while pending:
        done, pending = ray_tpu_torch.wait(pending, num_returns=1)
        ref = done[0]
        task_id, key = submitted[ref]
        try:
            value = ray_tpu_torch.get(ref)
        except BaseException as e:
            first_error = first_error or e
            continue
        storage.save(task_id, value)
        ctx.cache[key] = value
    if first_error is not None:
        raise first_error
    out = _resolve(root, ctx)
    if isinstance(out, list):
        out = [ray_tpu_torch.get(o) if _is_ref(o) else o for o in out]
    elif _is_ref(out):
        out = ray_tpu_torch.get(out)
    return out


def _is_ref(x) -> bool:
    from ray_tpu_torch.core.object_ref import ObjectRef
    return isinstance(x, ObjectRef)


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        **kwargs) -> Any:
    """Execute durably; re-running a finished workflow returns the
    stored output without re-executing."""
    workflow_id = workflow_id or f"wf_{uuid.uuid4().hex[:12]}"
    storage = _WorkflowStorage(workflow_id)
    if storage.has_output():
        return storage.load_output()
    storage.set_meta(status=RUNNING, workflow_id=workflow_id,
                     start_time=time.time())
    if storage.load_dag() is None:
        import cloudpickle
        try:
            storage.save_dag(cloudpickle.dumps((dag, args, kwargs)))
        except Exception:
            pass  # unpicklable DAG: resumable only by re-passing it
    try:
        out = _execute_durable(dag, storage, args, kwargs)
    except BaseException as e:
        storage.set_meta(status=FAILED, error=repr(e),
                         end_time=time.time())
        raise
    storage.save_output(out)
    storage.set_meta(status=SUCCESSFUL, end_time=time.time())
    return out


def run_async(dag: DAGNode, *args, workflow_id: Optional[str] = None,
              **kwargs):
    """Returns an ObjectRef-like future via a thread (the reference
    returns an ObjectRef from the workflow management actor)."""
    global _async_pool
    import concurrent.futures
    if _async_pool is None:
        _async_pool = concurrent.futures.ThreadPoolExecutor(8)
    return _async_pool.submit(
        run, dag, *args, workflow_id=workflow_id, **kwargs)


def resume(workflow_id: str) -> Any:
    """Re-run an interrupted workflow; completed tasks are skipped."""
    storage = _WorkflowStorage(workflow_id)
    if storage.has_output():
        return storage.load_output()
    dag_bytes = storage.load_dag()
    if dag_bytes is None:
        raise ValueError(
            f"Workflow {workflow_id!r} cannot be resumed: no stored DAG "
            f"(pass the dag to `run` with the same workflow_id instead)")
    import cloudpickle
    dag, args, kwargs = cloudpickle.loads(dag_bytes)
    return run(dag, *args, workflow_id=workflow_id, **kwargs)


def get_status(workflow_id: str) -> Optional[str]:
    return _WorkflowStorage(workflow_id, create=False).meta().get("status")


def get_metadata(workflow_id: str) -> Dict[str, Any]:
    return _WorkflowStorage(workflow_id, create=False).meta()


def get_output(workflow_id: str) -> Any:
    storage = _WorkflowStorage(workflow_id, create=False)
    if not storage.has_output():
        raise ValueError(f"Workflow {workflow_id!r} has no output yet")
    return storage.load_output()


def list_all(status_filter: Optional[str] = None) -> List[tuple]:
    out = []
    base = _storage()
    for wf_id in sorted(os.listdir(base)):
        if not os.path.isdir(os.path.join(base, wf_id)):
            continue
        meta = _WorkflowStorage(wf_id, create=False).meta()
        status = meta.get("status")
        if status and (status_filter is None or status == status_filter):
            out.append((wf_id, status))
    return out


def delete(workflow_id: str) -> None:
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
