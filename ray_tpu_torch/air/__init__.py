"""ray_tpu_torch.air: shared ML plumbing, the port of ``ray_tpu/air/``
(reference: ``python/ray/air/``). The run configs only:
``air/integrations/`` waits for the port of the libraries (ROADMAP
Queue 1 item 11)."""

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
