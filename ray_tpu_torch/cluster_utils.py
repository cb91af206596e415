"""Multi-node simulation on one machine.

Reference: ``python/ray/cluster_utils.py:108`` — ``Cluster``/
``add_node`` start extra raylets against one GCS so distributed
scheduling/failure tests need no real cluster (SURVEY §4). Here extra
node managers run as subprocesses joining the head session.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional

import ray_tpu_torch


class _NodeProc:
    def __init__(self, proc: subprocess.Popen, node_id_hint: str):
        self.proc = proc
        self.node_id_hint = node_id_hint

    def kill(self, sig=None) -> None:
        self.proc.kill()
        self.proc.wait(timeout=10)


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 connect: bool = False,
                 head_node_args: Optional[Dict] = None):
        self._nodes: List[_NodeProc] = []
        self._head_info = None
        self.session_dir: Optional[str] = None
        if initialize_head:
            args = dict(head_node_args or {})
            args.setdefault("num_cpus", 2)
            self._head_info = ray_tpu_torch.init(**args)
            self.session_dir = self._head_info.get("session_dir")
            self._connected = True
        else:
            self._connected = connect

    @property
    def address(self) -> Optional[str]:
        return self.session_dir

    def add_node(self, *, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 wait: bool = True, env: Optional[Dict] = None) -> _NodeProc:
        assert self.session_dir, "head must be started first"
        before = {n["node_id"] for n in ray_tpu_torch.nodes()}
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.node",
               "--session-dir", self.session_dir,
               "--num-cpus", str(num_cpus),
               "--resources", json.dumps(resources or {}),
               "--labels", json.dumps(labels or {}),
               "--initial-workers", "0"]
        if num_gpus:
            cmd += ["--num-gpus", str(num_gpus)]
        child_env = dict(os.environ)
        child_env.update(env or {})
        proc = subprocess.Popen(
            cmd, env=child_env,
            stdout=open(os.path.join(
                self.session_dir, "logs",
                f"node-{len(self._nodes)}.out"), "ab"),
            stderr=subprocess.STDOUT)
        node = _NodeProc(proc, "")
        self._nodes.append(node)
        if wait:
            deadline = time.time() + 30
            while time.time() < deadline:
                now = {n["node_id"] for n in ray_tpu_torch.nodes()
                       if n["alive"]}
                new = now - before
                if new:
                    node.node_id_hint = next(iter(new))
                    return node
                time.sleep(0.2)
            raise TimeoutError("node did not register within 30s")
        return node

    def remove_node(self, node: _NodeProc) -> None:
        node.kill()
        self._nodes.remove(node)

    def kill_random_node(self) -> None:
        import random
        if self._nodes:
            self.remove_node(random.choice(self._nodes))

    def wait_for_nodes(self, timeout: float = 30) -> None:
        expect = 1 + len(self._nodes)
        deadline = time.time() + timeout
        while True:
            alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            if len(alive) >= expect:
                return
            if time.time() >= deadline:
                raise TimeoutError(
                    f"expected {expect} alive nodes, have {len(alive)}")
            time.sleep(0.2)

    def shutdown(self) -> None:
        for node in list(self._nodes):
            try:
                self.remove_node(node)
            except Exception:
                pass
        if self._connected:
            ray_tpu_torch.shutdown()
