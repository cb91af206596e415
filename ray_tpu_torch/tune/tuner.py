"""Tuner: the public tuning entry point.

Reference: ``python/ray/tune/tuner.py:54`` (``fit`` :354) +
``tune_config.py`` (``TuneConfig``) + ``impl/tuner_internal.py``.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train._internal.storage import StorageContext
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import Searcher
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclasses.dataclass
class TuneConfig:
    """Reference: ``python/ray/tune/tune_config.py``."""

    metric: Optional[str] = None
    mode: Optional[str] = None
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    time_budget_s: Optional[float] = None
    reuse_actors: bool = False

    def __post_init__(self):
        if self.mode is not None and self.mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")


class Tuner:
    def __init__(self, trainable=None, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _controller: Optional[TuneController] = None):
        self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._controller = _controller

    def _make_controller(self) -> TuneController:
        name = self.run_config.name or (
            f"tune_{time.strftime('%Y-%m-%d_%H-%M-%S')}"
            f"_{uuid.uuid4().hex[:6]}")
        self.run_config.name = name
        storage = StorageContext(self.run_config.storage_path, name)
        cc = self.run_config.checkpoint_config
        # When the trainable is a Trainer, unwrap to its tune trainable.
        trainable = self._trainable
        from ray_tpu_torch.train.base_trainer import BaseTrainer
        if isinstance(trainable, BaseTrainer):
            trainable = trainable.as_trainable()
        return TuneController(
            trainable, self.param_space,
            searcher=self.tune_config.search_alg,
            scheduler=self.tune_config.scheduler,
            storage=storage,
            metric=self.tune_config.metric,
            mode=self.tune_config.mode,
            num_samples=self.tune_config.num_samples,
            max_concurrent_trials=self.tune_config.max_concurrent_trials,
            stop=self.run_config.stop,
            max_failures=self.run_config.failure_config.max_failures,
            checkpoint_frequency=cc.checkpoint_frequency,
            checkpoint_at_end=(cc.checkpoint_at_end
                               if cc.checkpoint_at_end is not None
                               else True),
            callbacks=self.run_config.callbacks)

    def fit(self) -> ResultGrid:
        if self._controller is None:
            self._controller = self._make_controller()
        trials = self._controller.run()
        return ResultGrid(
            trials, metric=self.tune_config.metric,
            mode=self.tune_config.mode or "max",
            experiment_path=self._controller.storage.experiment_dir)

    def get_results(self) -> ResultGrid:
        if self._controller is None:
            raise RuntimeError("fit() has not been called")
        return ResultGrid(
            self._controller.trials, metric=self.tune_config.metric,
            mode=self.tune_config.mode or "max",
            experiment_path=self._controller.storage.experiment_dir)

    @classmethod
    def restore(cls, path: str, trainable,
                param_space: Optional[Dict] = None,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment from its directory
        (reference ``Tuner.restore``): terminated trials keep their
        results; unfinished ones restart from their last checkpoint."""
        path = os.path.abspath(os.path.expanduser(path))
        name = os.path.basename(path.rstrip("/"))
        storage_path = os.path.dirname(path.rstrip("/"))
        run_config = RunConfig(name=name, storage_path=storage_path)
        tuner = cls(trainable, param_space=param_space,
                    tune_config=tune_config, run_config=run_config)
        controller = tuner._make_controller()
        if not controller.load_snapshot():
            raise ValueError(f"No experiment state found at {path}")
        controller._searcher_done = True  # only resume existing trials
        tuner._controller = controller
        return tuner

    @classmethod
    def can_restore(cls, path: str) -> bool:
        return os.path.exists(
            os.path.join(path, "experiment_state.pkl"))


def run(trainable, *, config: Optional[Dict] = None, num_samples: int = 1,
        metric: Optional[str] = None, mode: Optional[str] = None,
        search_alg=None, scheduler=None, stop=None, storage_path=None,
        name=None, max_concurrent_trials=None, **_ignored) -> ResultGrid:
    """Classic ``tune.run`` API (reference ``python/ray/tune/tune.py``)."""
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples,
            search_alg=search_alg, scheduler=scheduler,
            max_concurrent_trials=max_concurrent_trials),
        run_config=RunConfig(name=name, storage_path=storage_path,
                             stop=stop))
    return tuner.fit()
