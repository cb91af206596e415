"""ray_tpu_torch.train: distributed training, the port of
``ray_tpu/train/`` (reference: ``python/ray/train/``).

Public surface mirrors ``ray.train``: configs, Checkpoint (with
``from_torch`` / ``to_torch``, the counterparts of ``from_jax`` /
``to_jax``, in the same files), Result,
``report``/``get_checkpoint``/``get_context``/``get_dataset_shard``, the
generic DataParallelTrainer, and TorchTrainer over ``TorchConfig`` (the
counterparts of the JAX package's ``JaxTrainer`` and ``JaxConfig``,
whose names raise here).
"""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

#: names of the JAX package's ``train`` with a torch counterpart here
_TORCH_NAMES = {"JaxConfig": "TorchConfig", "JaxTrainer": "TorchTrainer"}


def __getattr__(name):
    if name in _TORCH_NAMES:
        raise NotImplementedError(
            f"train.{name} is the JAX package's; the port's is "
            f"train.{_TORCH_NAMES[name]}")
    raise AttributeError(name)


__all__ = [
    "Backend",
    "BackendConfig",
    "BaseTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "DataParallelTrainer",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchConfig",
    "TorchTrainer",
    "TrainContext",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "report",
]
