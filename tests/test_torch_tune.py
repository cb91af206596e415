"""The JAX package's ``tests/tune/test_tune.py`` and
``tests/tune/test_callbacks.py`` bodies on the port (loaded by
``tests/test_torch_runtime_loader.py``): variants and search spaces, a
function and a class trainable through ``Tuner``, ASHA, restore, a
trial's retry, ``with_parameters``/``with_resources`` through
``tune.run``, a ``DataParallelTrainer`` tuned over its trial's placement
group, and the callbacks and loggers.

Left out, each waiting for ROADMAP Queue 1 item 11 (tune's other
schedulers, its optional searchers, ``air/integrations/``):

- ``test_median_stopping_rule_decisions`` and
  ``test_median_stopping_soft_pause_releases_resources``:
  ``MedianStoppingRule``;
- ``test_pbt_exploits``: ``PopulationBasedTraining``;
- ``test_search_wrappers_are_gated``: ``HyperOptSearch`` and
  ``BayesOptSearch`` raise ``NotImplementedError`` naming the item
  (``test_the_waiting_searchers_and_schedulers_name_their_item``);
- ``test_integrations_are_gated``: ``air/integrations/``;
- the whole of ``tests/tune/test_new_schedulers.py``: PB2, BOHB,
  HyperBand, the resource-changing scheduler and the optional searchers.

The callbacks file's own 4-CPU runtime is left out too: its body runs on
the 8-CPU runtime the others share.
"""

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests, ray_session

WAITS = "waits for tune's other schedulers (ROADMAP Queue 1 item 11)"
LEAVE_OUT_TUNE = {
    "test_median_stopping_rule_decisions": "MedianStoppingRule " + WAITS,
    "test_median_stopping_soft_pause_releases_resources":
        "MedianStoppingRule " + WAITS,
    "test_pbt_exploits": "PopulationBasedTraining " + WAITS,
}
LEAVE_OUT_CALLBACKS = {
    "test_search_wrappers_are_gated":
        "HyperOptSearch and BayesOptSearch wait for ROADMAP Queue 1 item "
        "11",
    "test_integrations_are_gated":
        "air/integrations/ waits for ROADMAP Queue 1 item 11",
    "ray_session": "the bodies share the loader's 8-CPU runtime",
}

globals().update(FIXTURES)
globals().update(load_core_tests(
    "tune/test_tune.py", LEAVE_OUT_TUNE,
    edits=[("ASHAScheduler, MedianStoppingRule, PopulationBasedTraining)",
            "ASHAScheduler)")]))
globals().update(load_core_tests("tune/test_callbacks.py",
                                 LEAVE_OUT_CALLBACKS))
globals()["ray_session"] = ray_session


@pytest.mark.parametrize("module, name", [
    ("ray_tpu_torch.tune.search", "HyperOptSearch"),
    ("ray_tpu_torch.tune.search", "BayesOptSearch"),
    ("ray_tpu_torch.tune.search", "OptunaSearch"),
    ("ray_tpu_torch.tune.schedulers", "MedianStoppingRule"),
    ("ray_tpu_torch.tune.schedulers", "PopulationBasedTraining"),
    ("ray_tpu_torch.tune.schedulers", "PB2"),
    ("ray_tpu_torch.tune.schedulers", "HyperBandScheduler"),
    ("ray_tpu_torch.tune.schedulers", "TuneBOHB"),
    ("ray_tpu_torch.tune.schedulers", "ResourceChangingScheduler"),
])
def test_the_waiting_searchers_and_schedulers_name_their_item(module, name):
    import importlib
    mod = importlib.import_module(module)
    with pytest.raises(NotImplementedError, match="item 11"):
        getattr(mod, name)(metric="m", mode="max")
