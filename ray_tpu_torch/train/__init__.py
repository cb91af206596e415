"""ray_tpu_torch.train: the part of ``ray_tpu/train/`` that
``tune.Trainable`` and rllib read, ``Checkpoint`` (with ``from_torch`` /
``to_torch``, the counterparts of ``from_jax`` / ``to_jax``, in the same
files). The session, the trainers, backends and results wait for the
port of ``train/`` (ROADMAP Queue 1 item 10), the run configs for
``air/`` (item 11); their names raise on access.
"""

from ray_tpu_torch.train._checkpoint import Checkpoint

#: names of the JAX package's ``train`` that wait, by ROADMAP Queue 1 item
_LATER = {"Backend": 10, "BackendConfig": 10, "BaseTrainer": 10,
          "DataParallelTrainer": 10, "JaxConfig": 10, "JaxTrainer": 10,
          "Result": 10, "TrainContext": 10, "get_checkpoint": 10,
          "get_context": 10, "get_dataset_shard": 10, "report": 10,
          "CheckpointConfig": 11, "FailureConfig": 11, "RunConfig": 11,
          "ScalingConfig": 11}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"train.{name} waits for the port of "
            f"{'train/' if _LATER[name] == 10 else 'air/'} (ROADMAP Queue 1 "
            f"item {_LATER[name]})")
    raise AttributeError(name)


__all__ = ["Checkpoint"]
