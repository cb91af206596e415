from ray_tpu_torch.tune.search.sample import (
    choice, grid_search, lograndint, loguniform, qloguniform, qrandint,
    quniform, randint, randn, sample_from, uniform)
from ray_tpu_torch.tune.search.searcher import (
    BasicVariantGenerator, BayesOptSearch, ConcurrencyLimiter,
    HyperOptSearch, OptunaSearch, Searcher)

__all__ = [
    "BasicVariantGenerator", "BayesOptSearch", "ConcurrencyLimiter",
    "HyperOptSearch", "OptunaSearch",
    "Searcher", "choice", "grid_search", "lograndint", "loguniform",
    "qloguniform", "qrandint", "quniform", "randint", "randn",
    "sample_from", "uniform",
]
