"""ray_tpu_torch.air: shared ML plumbing, the port of ``ray_tpu/air/``
(reference: ``python/ray/air/``): the run configs, and the
experiment-tracking adapters in ``air/integrations/``."""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)

__all__ = [
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
]
