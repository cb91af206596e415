"""ray_tpu_torch.tune: the part of ``ray_tpu/tune/`` that rllib's
``Algorithm`` stands on, the class API ``Trainable``
(``tune/trainable.py``). The function API, ``with_resources``,
``Tuner``, the search spaces, searchers and schedulers wait for the port
of ``tune/`` (ROADMAP Queue 1 item 11); their names raise on access.
"""

from ray_tpu_torch.tune.trainable import Trainable

#: names of the JAX package's ``tune`` that wait for item 11
_LATER = ("FunctionTrainable", "PlacementGroupFactory", "ResultGrid",
          "TuneConfig", "Tuner", "choice", "get_checkpoint",
          "grid_search", "lograndint", "loguniform", "qloguniform",
          "qrandint", "quniform", "randint", "randn", "report", "run",
          "sample_from", "uniform", "with_parameters", "with_resources")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"tune.{name} waits for the port of tune/ (ROADMAP Queue 1 "
            f"item 11)")
    raise AttributeError(name)


__all__ = ["Trainable"]
