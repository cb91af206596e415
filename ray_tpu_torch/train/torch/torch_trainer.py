"""TorchTrainer: data-parallel (and sharded) training over a gang of
torch workers, the counterpart of ``ray_tpu/train/jax/jax_trainer.py``.

Reference shape: ``python/ray/train/torch/torch_trainer.py`` (a
DataParallelTrainer bound to the framework backend): one worker actor
per rank, a ``torch.distributed`` process group formed by
``TorchConfig``, and the user's ``train_func`` building a mesh over it
(dp/fsdp/tp/sp axes via ``ray_tpu_torch.parallel``) and stepping
``models.training.make_train_step``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


class TorchTrainer(DataParallelTrainer):
    _backend_config_cls = TorchConfig

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 dataset_config: Optional[Any] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 metadata: Optional[Dict[str, Any]] = None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            dataset_config=dataset_config,
            resume_from_checkpoint=resume_from_checkpoint,
            metadata=metadata)
