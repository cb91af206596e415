"""Trial schedulers, the port of ``ray_tpu/tune/schedulers/``: FIFO and
ASHA. The others wait for the port of tune's other schedulers (ROADMAP
Queue 1 item 11); their names raise on access."""

from ray_tpu_torch.tune.schedulers.async_hyperband import (
    ASHAScheduler, AsyncHyperBandScheduler)
from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler, TrialScheduler)

#: schedulers of the JAX package that wait for item 11
_LATER = ("DistributeResources", "HyperBandForBOHB", "HyperBandScheduler",
          "MedianStoppingRule", "PB2", "PopulationBasedTraining",
          "ResourceChangingScheduler", "TuneBOHB")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"tune.schedulers.{name} waits for the port of tune's other "
            f"schedulers (ROADMAP Queue 1 item 11)")
    raise AttributeError(name)


__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "FIFOScheduler",
    "TrialScheduler",
]
