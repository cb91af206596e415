"""WorkerGroup: a gang of TrainWorker actors, one per rank.

Reference: ``python/ray/train/_internal/worker_group.py`` —
``RayTrainWorker`` :19 (thin actor wrapping the session) and
``WorkerGroup`` :102 (create/sort/execute/shutdown). Workers are sorted
by (node ip, the CUDA devices the worker sees) so world ranks are
contiguous per host, as ``torch.distributed``'s local ranks expect. A
worker's share of a card (``GPU`` in its bundle) is its ``num_gpus``.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal import session as session_lib
from ray_tpu_torch.train._internal.storage import StorageContext


class RayTrainWorker:
    """Actor running one training process (reference worker_group.py:19)."""

    def __init__(self):
        self._session: Optional[session_lib._TrainSession] = None

    # Generic execution hook used by backends for env/setup fan-out.
    def execute(self, fn: Callable, *args, **kwargs) -> Any:
        return fn(*args, **kwargs)

    def metadata(self) -> Dict[str, Any]:
        ctx = ray_tpu_torch.get_runtime_context()
        return {
            "node_id": ctx.get_node_id(),
            "node_ip": socket.gethostbyname(socket.gethostname()),
            "pid": os.getpid(),
            "cuda_devices": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
        }

    def init_session(self, train_func: Callable, world_rank: int,
                      world_size: int, local_rank: int,
                      local_world_size: int, node_rank: int,
                      storage: Optional[StorageContext],
                      checkpoint: Optional[Checkpoint],
                      experiment_name: str, trial_name: str,
                      trial_id: str, dataset_shards: Optional[dict] = None
                      ) -> None:
        s = session_lib.init_session(
            train_func=train_func, world_rank=world_rank,
            world_size=world_size, local_rank=local_rank,
            local_world_size=local_world_size, node_rank=node_rank,
            storage=storage, checkpoint=checkpoint,
            experiment_name=experiment_name, trial_name=trial_name,
            trial_id=trial_id)
        if dataset_shards:
            s.dataset_shards = dataset_shards
        self._session = s

    def start_training(self) -> None:
        assert self._session is not None
        self._session.start()

    def get_next(self) -> session_lib._TrainingResult:
        assert self._session is not None
        return self._session.get_next()

    def shutdown_session(self) -> None:
        session_lib.shutdown_session()
        self._session = None


@dataclass
class WorkerMetadata:
    node_id: str
    node_ip: str
    pid: int
    cuda_devices: str


class WorkerGroup:
    """Reference ``worker_group.py:102``."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_group=None, bundle_offset: int = 1,
                 actor_cls_env: Optional[dict] = None):
        self.num_workers = num_workers
        self._pg = placement_group
        opts: Dict[str, Any] = {}
        rpw = dict(resources_per_worker or {"CPU": 1.0})
        opts["num_cpus"] = float(rpw.pop("CPU", 1.0))
        #: each worker's share of a card (a torch backend picks NCCL
        #: for whole cards only)
        self.gpus_per_worker = float(rpw.pop("GPU", 0.0))
        if self.gpus_per_worker:
            opts["num_gpus"] = self.gpus_per_worker
        if rpw:
            opts["resources"] = rpw
        remote_cls = ray_tpu_torch.remote(**opts)(RayTrainWorker)
        self.workers: List[Any] = []
        self.metadata: List[WorkerMetadata] = []
        for i in range(num_workers):
            w_opts = {}
            if placement_group is not None:
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy)
                # Worker bundles start after the trainer's head bundle
                # (offset 0 when the head bundle was empty/absent).
                w_opts["scheduling_strategy"] = (
                    PlacementGroupSchedulingStrategy(
                        placement_group,
                        placement_group_bundle_index=i + bundle_offset))
            self.workers.append(remote_cls.options(**w_opts).remote())

    def fetch_metadata(self) -> List[WorkerMetadata]:
        metas = ray_tpu_torch.get(
            [w.metadata.remote() for w in self.workers])
        self.metadata = [WorkerMetadata(**m) for m in metas]
        return self.metadata

    def sort_workers_by_node(self) -> None:
        """Group workers by node ip then CUDA devices → contiguous host
        ranks (reference ``backend_executor.py:363``)."""
        if not self.metadata:
            self.fetch_metadata()
        order = sorted(
            range(len(self.workers)),
            key=lambda i: (self.metadata[i].node_ip,
                           self.metadata[i].cuda_devices,
                           self.metadata[i].pid))
        self.workers = [self.workers[i] for i in order]
        self.metadata = [self.metadata[i] for i in order]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(
            [w.execute.remote(fn, *args, **kwargs) for w in self.workers])

    def execute_async(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return [w.execute.remote(fn, *args, **kwargs)
                for w in self.workers]

    def execute_single(self, index: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(
            self.workers[index].execute.remote(fn, *args, **kwargs))

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        self.metadata = []

    def __len__(self) -> int:
        return len(self.workers)
