"""DataParallelTrainer: run one train_func per worker in SPMD.

Reference: ``python/ray/train/data_parallel_trainer.py:22``
(``training_loop`` :419): BackendExecutor start → start_training →
drain results → finish, with ``FailureConfig.max_failures`` gang
restarts from the latest checkpoint (``backend_executor.py:690``).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor, TrainingWorkerError)
from ray_tpu_torch.train.result import Result


def _wrap_train_func(train_func: Callable,
                     config: Optional[Dict[str, Any]]) -> Callable[[], Any]:
    sig = inspect.signature(train_func)
    if len(sig.parameters) == 0:
        return train_func
    cfg = dict(config or {})
    return lambda: train_func(cfg)


class DataParallelTrainer(BaseTrainer):
    _backend_config_cls = BackendConfig

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 dataset_config: Optional[Any] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 metadata: Optional[Dict[str, Any]] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint,
                         metadata=metadata)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.backend_config = backend_config or self._backend_config_cls()
        self.datasets = datasets or {}
        self.dataset_config = dataset_config

    def _dataset_shards(self, num_workers: int):
        """Split each dataset into per-worker shards
        (reference ``DataConfig.configure``,
        ``train/_internal/data_config.py``)."""
        if not self.datasets:
            return None
        shards = [dict() for _ in range(num_workers)]
        for name, ds in self.datasets.items():
            split = getattr(ds, "streaming_split", None)
            if split is not None:
                for i, shard in enumerate(split(num_workers)):
                    shards[i][name] = shard
            else:
                for i in range(num_workers):
                    shards[i][name] = ds
        return shards

    def training_loop(self) -> Result:
        storage = self._make_storage()
        manager = self._make_checkpoint_manager(storage)
        failure_config = self.run_config.failure_config
        train_func = _wrap_train_func(
            self.train_loop_per_worker, self.train_loop_config)

        executor = BackendExecutor(
            backend_config=self.backend_config,
            scaling_config=self.scaling_config,
            storage=storage,
            experiment_name=self.run_config.name or "",
            trial_name=self.run_config.name or "",
            trial_id=self.run_config.name or "")

        latest_metrics: Dict[str, Any] = {}
        checkpoint = self.resume_from_checkpoint
        failures = 0
        error: Optional[BaseException] = None
        # Inside a Tune trial the trial's placement group already reserves
        # the worker bundles — reuse it instead of reserving twice.
        from ray_tpu_torch.tune._trial_context import get_trial_placement_group
        trial_pg = get_trial_placement_group()
        try:
            executor.start(placement_group=trial_pg)
            executor.start_training(
                train_func, checkpoint=checkpoint,
                dataset_shards=self._dataset_shards(
                    self.scaling_config.num_workers))
            while True:
                try:
                    results = executor.get_next_results()
                except TrainingWorkerError as e:
                    max_failures = failure_config.max_failures
                    if failure_config.fail_fast or (
                            max_failures >= 0 and failures >= max_failures):
                        error = e
                        break
                    failures += 1
                    # Gang restart from the last persisted checkpoint.
                    checkpoint = manager.latest_checkpoint or checkpoint
                    executor.restart()
                    executor.start_training(
                        train_func, checkpoint=checkpoint,
                        dataset_shards=self._dataset_shards(
                            self.scaling_config.num_workers))
                    continue
                except BaseException as e:
                    error = e
                    break
                if results is None:
                    break
                # Rank 0's metrics are the run's metrics (reference
                # convention); rank 0's checkpoint is registered.
                latest_metrics = dict(results[0].metrics)
                ckpt = results[0].checkpoint
                if ckpt is not None:
                    manager.register_checkpoint(ckpt, latest_metrics)
                    # Advance the driver-side index so a gang restart
                    # hands workers a StorageContext that numbers past
                    # already-persisted checkpoints.
                    import os as _os
                    base = _os.path.basename(ckpt.path.rstrip("/"))
                    if base.startswith("checkpoint_"):
                        storage.current_checkpoint_index = max(
                            storage.current_checkpoint_index,
                            int(base.split("_")[-1]) + 1)
        finally:
            executor.shutdown()

        return Result(
            metrics=latest_metrics or None,
            checkpoint=manager.latest_checkpoint,
            path=storage.trial_dir,
            error=error,
            best_checkpoints=manager.checkpoints)
