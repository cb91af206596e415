"""BaseTrainer: config container + fit() driver loop.

Reference: ``python/ray/train/base_trainer.py:107`` (``fit`` :561). The
reference wraps every trainer in a single-trial Tune run
(``TrainTrainable`` :711); this build does the same when Tune is driving
(``as_trainable()``), and runs the identical loop directly for plain
``.fit()`` so single runs don't pay Tune overhead.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import (
    CheckpointConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.storage import CheckpointManager, StorageContext
from ray_tpu_torch.train.result import Result


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 metadata: Optional[Dict[str, Any]] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}

    # Subclasses implement the actual loop against a BackendExecutor.
    def training_loop(self) -> Result:
        raise NotImplementedError

    def fit(self) -> Result:
        return self.training_loop()

    # -- Tune integration --------------------------------------------
    def as_trainable(self):
        """Wrap as a Tune trainable (reference ``TrainTrainable`` :711)."""
        from ray_tpu_torch.tune.trainable import FunctionTrainable
        trainer = self

        def _train_fn(config: Dict[str, Any]):
            from ray_tpu_torch.tune import trainable as _t
            from ray_tpu_torch.tune._trial_context import get_trial_dir
            import copy
            import os
            t = copy.copy(trainer)
            if config:
                t = t._with_parameters(config)
            # Under Tune each trial gets its own directory; point the
            # inner run's storage there so concurrent trials never share
            # checkpoint paths.
            trial_dir = get_trial_dir()
            if trial_dir:
                t.run_config = copy.copy(t.run_config)
                t.run_config.name = os.path.basename(trial_dir.rstrip("/"))
                t.run_config.storage_path = os.path.dirname(
                    trial_dir.rstrip("/"))
            result = t.fit()
            if result.error:
                raise result.error
            _t.report(result.metrics or {},
                      checkpoint=result.checkpoint)

        _train_fn.__name__ = type(self).__name__
        trainable = FunctionTrainable.wrap(_train_fn)
        trainable.default_resource_request = (
            lambda config: self.scaling_config.as_placement_group_factory())
        return trainable

    # Trainer attributes sweepable from a Tune param_space (reference
    # allows trainer __init__ kwargs as siblings of train_loop_config).
    _SWEEPABLE_ATTRS = ("scaling_config", "run_config", "backend_config",
                        "datasets", "metadata", "dataset_config")

    def _with_parameters(self, config: Dict[str, Any]) -> "BaseTrainer":
        import copy
        t = copy.copy(self)
        overrides = dict(config)
        loop = overrides.pop("train_loop_config", None)
        for attr in self._SWEEPABLE_ATTRS:
            if attr in overrides:
                setattr(t, attr, overrides.pop(attr))
        if loop is None:
            # Flat dict: everything remaining is loop config.
            loop = overrides
            overrides = {}
        if overrides:
            raise ValueError(
                f"Unknown trainer param_space keys: {sorted(overrides)}; "
                f"nest hyperparameters under 'train_loop_config' or use "
                f"one of {self._SWEEPABLE_ATTRS}")
        loop_cfg = dict(getattr(t, "train_loop_config", None) or {})
        loop_cfg.update(loop)
        t.train_loop_config = loop_cfg
        return t

    @classmethod
    def restore(cls, path: str, **kwargs) -> "BaseTrainer":
        """Resume a trainer from a run directory's latest checkpoint
        (reference ``base_trainer.py:577``)."""
        import os
        ckpts = sorted(
            d for d in os.listdir(path) if d.startswith("checkpoint_"))
        if not ckpts:
            raise ValueError(f"No checkpoints under {path}")
        kwargs.setdefault(
            "resume_from_checkpoint",
            Checkpoint(os.path.join(path, ckpts[-1])))
        run_name = os.path.basename(path.rstrip("/"))
        kwargs.setdefault(
            "run_config",
            RunConfig(name=run_name,
                      storage_path=os.path.dirname(path.rstrip("/"))))
        return cls(**kwargs)

    @classmethod
    def can_restore(cls, path: str) -> bool:
        import os
        return os.path.isdir(path) and any(
            d.startswith("checkpoint_") for d in os.listdir(path))

    def _make_storage(self) -> StorageContext:
        name = self.run_config.name or (
            f"{type(self).__name__}_{time.strftime('%Y-%m-%d_%H-%M-%S')}"
            f"_{uuid.uuid4().hex[:6]}")
        self.run_config.name = name
        return StorageContext(self.run_config.storage_path, name)

    def _make_checkpoint_manager(
            self, storage: StorageContext) -> CheckpointManager:
        cc: CheckpointConfig = self.run_config.checkpoint_config
        return CheckpointManager(
            storage, cc.num_to_keep,
            score_attribute=cc.checkpoint_score_attribute,
            score_order=cc.checkpoint_score_order)
