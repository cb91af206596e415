"""BackendExecutor: drives the worker-group lifecycle for one run.

Reference: ``python/ray/train/_internal/backend_executor.py:65`` —
``start`` :121 (placement group :197 + WorkerGroup + backend.on_start),
``start_training``, result polling, ``_restart`` :690 on worker failure.
Restarts are gang-granular: a dead rank invalidates the whole SPMD
gang (its process group with it), so the entire worker group is torn
down and rebuilt from the latest checkpoint, and the backend's
``on_start`` runs again on the fresh gang.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.exceptions import ActorDiedError, ActorError, RayTpuError
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.session import _TrainingResult
from ray_tpu_torch.train._internal.storage import StorageContext
from ray_tpu_torch.train._internal.worker_group import WorkerGroup


class TrainingWorkerError(RayTpuError):
    """A worker of the gang died mid-training (triggers group restart)."""


class TrainBackendError(RayTpuError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig,
                 storage: Optional[StorageContext] = None,
                 experiment_name: str = "", trial_name: str = "",
                 trial_id: str = ""):
        self._backend_config = backend_config
        self._backend: Backend = backend_config.backend_cls()
        self._scaling_config = scaling_config
        self._storage = storage
        self._experiment_name = experiment_name
        self._trial_name = trial_name
        self._trial_id = trial_id
        self.worker_group: Optional[WorkerGroup] = None
        self._pg = None          # owned placement group (we remove it)
        self._used_pg = None     # group used for (re)starts, owned or not
        self._bundle_offset = 1
        self._finished_ranks: set = set()

    # -- lifecycle ----------------------------------------------------
    def start(self, placement_group=None) -> None:
        sc = self._scaling_config
        factory = sc.as_placement_group_factory()
        # Worker bundles follow the trainer's head bundle unless the head
        # is empty and thus absent from the created group.
        self._bundle_offset = 0 if factory.head_bundle_is_empty else 1
        if placement_group is None:
            self._pg = factory()
            if not self._pg.wait(timeout_seconds=60):
                raise TrainBackendError(
                    f"Timed out reserving resources for {sc.num_workers} "
                    f"workers: {factory.required_resources()}")
            placement_group = self._pg
        # The group used for (re)starts — owned or externally supplied
        # (e.g. the enclosing Tune trial's reservation).
        self._used_pg = placement_group
        self.worker_group = WorkerGroup(
            num_workers=sc.num_workers,
            resources_per_worker=sc.worker_bundle(),
            placement_group=placement_group,
            bundle_offset=self._bundle_offset)
        self._backend.on_start(self.worker_group, self._backend_config)

    def start_training(self, train_func: Callable[[], Any],
                       checkpoint: Optional[Checkpoint] = None,
                       dataset_shards: Optional[List[dict]] = None) -> None:
        wg = self.worker_group
        assert wg is not None, "call start() first"
        self._finished_ranks = set()
        if not wg.metadata:
            wg.fetch_metadata()
        metas = wg.metadata
        node_ips = sorted({m.node_ip for m in metas})
        node_rank_of = {ip: i for i, ip in enumerate(node_ips)}
        local_rank_counter: Dict[str, int] = {}
        init_futs = []
        for rank, (worker, meta) in enumerate(zip(wg.workers, metas)):
            local_rank = local_rank_counter.get(meta.node_ip, 0)
            local_rank_counter[meta.node_ip] = local_rank + 1
            init_futs.append(worker.init_session.remote(
                train_func, rank, len(wg), local_rank,
                sum(1 for m in metas if m.node_ip == meta.node_ip),
                node_rank_of[meta.node_ip], self._storage, checkpoint,
                self._experiment_name, self._trial_name, self._trial_id,
                dataset_shards[rank] if dataset_shards else None))
        ray_tpu_torch.get(init_futs)
        self._backend.on_training_start(wg, self._backend_config)
        ray_tpu_torch.get([w.start_training.remote() for w in wg.workers])

    def get_next_results(self) -> Optional[List[_TrainingResult]]:
        """Fetch one result from every still-running worker (lockstep).
        Returns the results ordered by world rank (lowest live rank
        first), None when all workers finished cleanly; raises the user
        error if any worker's train_func raised; raises
        TrainingWorkerError if a worker process died. Finished workers
        are never polled again (their queue is empty — a second
        get_next would block forever)."""
        wg = self.worker_group
        assert wg is not None
        live = [rank for rank in range(len(wg.workers))
                if rank not in self._finished_ranks]
        if not live:
            return None
        futs = [wg.workers[rank].get_next.remote() for rank in live]
        try:
            results: List[_TrainingResult] = ray_tpu_torch.get(futs)
        except (ActorError, ActorDiedError) as e:
            raise TrainingWorkerError(str(e)) from e
        for r in results:
            if r.error is not None:
                raise r.error
        out = []
        for rank, r in zip(live, results):
            if r.done:
                self._finished_ranks.add(rank)
            else:
                out.append(r)
        if len(self._finished_ranks) == len(wg.workers):
            return None
        # Ragged finish round: drop the done markers, keep live results.
        return out if out else self.get_next_results()

    def shutdown(self) -> None:
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(
                    self.worker_group, self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import remove_placement_group
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    def restart(self) -> None:
        """Slice-granular restart (reference ``_restart`` :690). Reuses
        the original reservation, whether owned or externally supplied."""
        wg = self.worker_group
        if wg is not None:
            wg.shutdown()
        sc = self._scaling_config
        self.worker_group = WorkerGroup(
            num_workers=sc.num_workers,
            resources_per_worker=sc.worker_bundle(),
            placement_group=self._used_pg,
            bundle_offset=self._bundle_offset)
        self._backend.on_start(self.worker_group, self._backend_config)
