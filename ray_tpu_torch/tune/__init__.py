"""ray_tpu_torch.tune: hyperparameter tuning, the port of
``ray_tpu/tune/`` (reference: ``python/ray/tune/``).

Public surface mirrors ``ray.tune``: Tuner/TuneConfig/ResultGrid, the
search-space DSL, searchers, trial schedulers, Trainable (class and
function APIs), ``tune.report``, and the classic ``tune.run``.
"""

from ray_tpu_torch.tune.placement_groups import PlacementGroupFactory
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.search.sample import (
    choice, grid_search, lograndint, loguniform, qloguniform, qrandint,
    quniform, randint, randn, sample_from, uniform)
from ray_tpu_torch.tune.trainable import (
    FunctionTrainable, Trainable, get_checkpoint, report, with_parameters,
    with_resources)
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run

__all__ = [
    "FunctionTrainable",
    "PlacementGroupFactory",
    "ResultGrid",
    "Trainable",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "lograndint",
    "loguniform",
    "qloguniform",
    "qrandint",
    "quniform",
    "randint",
    "randn",
    "report",
    "run",
    "sample_from",
    "uniform",
    "with_parameters",
    "with_resources",
]
