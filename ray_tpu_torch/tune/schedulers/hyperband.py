"""HyperBand (bracketed successive halving).

Reference: ``python/ray/tune/schedulers/hyperband.py``. This build
implements the multi-bracket *asynchronous* formulation (the reference
docs themselves recommend ASHA over synchronous HyperBand because
stragglers stall whole bands); brackets differ in their grace period,
matching HyperBand's exploration/exploitation spread without PAUSE
barriers.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.tune.schedulers.async_hyperband import AsyncHyperBandScheduler
from ray_tpu_torch.tune.trainable import TRAINING_ITERATION


class HyperBandScheduler(AsyncHyperBandScheduler):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = TRAINING_ITERATION,
                 max_t: float = 81, reduction_factor: float = 3):
        super().__init__(
            metric=metric, mode=mode, time_attr=time_attr, max_t=max_t,
            grace_period=1, reduction_factor=reduction_factor,
            brackets=3)
