"""Shared ML-plumbing configs, the port of ``ray_tpu/air/config.py``
(reference: ``python/ray/air/config.py``: ``ScalingConfig`` :101,
``FailureConfig`` :375, ``CheckpointConfig`` :425, ``RunConfig`` :574).

The port schedules CUDA devices as the runtime's ``GPU`` resource, so
its ``ScalingConfig`` speaks GPUs where the JAX package's speaks TPU
chips: ``use_gpu`` gives each worker ``{"GPU": 1}``, or its
``resources_per_worker["GPU"]``, which may be a fraction (ranks that
share one card). ``use_tpu`` and ``topology`` (a TPU pod slice's gang
resource) raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How much compute a trainer gets (reference ``air/config.py:101``)."""

    num_workers: int = 1
    use_tpu: bool = False
    use_gpu: bool = False
    trainer_resources: Optional[Dict[str, float]] = None
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None

    def __post_init__(self):
        if self.use_tpu or self.topology:
            raise ValueError(
                "ScalingConfig: the port schedules CUDA devices (the GPU "
                "resource); use use_gpu=True, not use_tpu or a TPU "
                "topology")

    @property
    def _gpus_per_worker(self) -> float:
        rpw = self.resources_per_worker or {}
        if "GPU" in rpw:
            return float(rpw["GPU"])
        return 1.0 if self.use_gpu else 0.0

    def worker_bundle(self) -> Dict[str, float]:
        rpw = dict(self.resources_per_worker or {})
        bundle: Dict[str, float] = {}
        bundle["CPU"] = float(rpw.pop("CPU", 0.0 if self.use_gpu else 1.0))
        gpus = rpw.pop("GPU", self._gpus_per_worker)
        if gpus:
            bundle["GPU"] = float(gpus)
        bundle.update({k: float(v) for k, v in rpw.items()})
        return bundle

    def trainer_bundle(self) -> Dict[str, float]:
        tr = dict(self.trainer_resources or {"CPU": 1.0})
        return {k: float(v) for k, v in tr.items()}

    def as_placement_group_factory(self):
        from ray_tpu_torch.tune.placement_groups import PlacementGroupFactory
        bundles = [self.trainer_bundle()] + [
            self.worker_bundle() for _ in range(self.num_workers)]
        return PlacementGroupFactory(
            bundles, strategy=self.placement_strategy)

    @property
    def total_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = dict(self.trainer_bundle())
        wb = self.worker_bundle()
        for k, v in wb.items():
            total[k] = total.get(k, 0.0) + v * self.num_workers
        return total


@dataclass
class FailureConfig:
    """Restart-from-checkpoint policy (reference ``air/config.py:375``)."""

    max_failures: int = 0
    fail_fast: bool = False


@dataclass
class CheckpointConfig:
    """Top-K checkpoint retention (reference ``air/config.py:425``)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: Optional[bool] = None

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be None or > 0")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Run-level config (reference ``air/config.py:574``)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    log_to_file: bool = False
    #: tune.Callback instances (loggers, experiment trackers)
    callbacks: Optional[list] = None

    def __post_init__(self):
        if self.storage_path is None:
            self.storage_path = os.path.expanduser(os.environ.get(
                "RAY_TPU_TORCH_STORAGE_PATH", "~/ray_tpu_torch_results"))
