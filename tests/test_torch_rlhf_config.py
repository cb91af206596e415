"""The JAX package's ``tests/rlhf/test_config.py`` bodies on the port's
``RLHFConfig`` (loaded by ``tests/test_torch_runtime_loader.py``; the
placement's reserve and release run against the port's live
``SliceManager``), and twins that hold ``learner_plan()`` to the JAX
package's plan field for field."""

import dataclasses

from ray_tpu.rlhf.config import RLHFConfig as JaxRLHFConfig
from test_torch_runtime_loader import FIXTURES, load_core_tests

globals().update(FIXTURES)
globals().update(load_core_tests("rlhf/test_config.py"))


def _same_plan(kw):
    got = RLHFConfig(**kw).learner_plan()
    want = JaxRLHFConfig(**kw).learner_plan()
    assert type(got).__name__ == type(want).__name__ == "ParallelPlan"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.lowering == want.lowering == "spmd"
    assert got.describe() == want.describe()


def test_anakin_lowers_to_one_packed_shared_slice_but_no_plan():
    cfg = RLHFConfig(placement="anakin", num_learners=2, num_engines=3)
    assert cfg.slice_strategy == "SLICE_PACK"
    p = cfg.lower()
    assert p.num_slices == 1
    assert p.groups == [{"role": "shared", "engines": 3,
                         "learners": 2}]
    assert p.slice_strategy == "SLICE_PACK"
    _same_plan(dict(placement="anakin", num_learners=2, num_engines=3))


def test_sebulba_lowers_to_spread_rollout_and_train_slices_but_no_plan():
    cfg = RLHFConfig(placement="sebulba", num_learners=4,
                     num_engines=2)
    assert cfg.slice_strategy == "SLICE_SPREAD"
    p = cfg.lower()
    assert p.num_slices == 2
    roles = {g["role"]: g for g in p.groups}
    assert roles["rollout"] == {"role": "rollout", "engines": 2,
                                "learners": 0}
    assert roles["train"] == {"role": "train", "engines": 0,
                              "learners": 4}
    _same_plan(dict(placement="sebulba", num_learners=4, num_engines=2))
    assert cfg.model_config() == {"dtype": "float32"}
