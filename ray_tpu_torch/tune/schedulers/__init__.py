"""Trial schedulers, the port of ``ray_tpu/tune/schedulers/``."""

from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler, TrialScheduler)
from ray_tpu_torch.tune.schedulers.async_hyperband import (
    ASHAScheduler, AsyncHyperBandScheduler)
from ray_tpu_torch.tune.schedulers.bohb import HyperBandForBOHB, TuneBOHB
from ray_tpu_torch.tune.schedulers.hyperband import HyperBandScheduler
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule
from ray_tpu_torch.tune.schedulers.pb2 import PB2
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining
from ray_tpu_torch.tune.schedulers.resource_changing import (
    DistributeResources, ResourceChangingScheduler)

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "DistributeResources",
    "FIFOScheduler",
    "HyperBandForBOHB",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PB2",
    "PopulationBasedTraining",
    "ResourceChangingScheduler",
    "TrialScheduler",
    "TuneBOHB",
]
