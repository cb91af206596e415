"""The JAX package's ``tests/rlhf/test_config.py`` bodies on the port's
``RLHFConfig`` (loaded by ``tests/test_torch_runtime_loader.py``)."""

import pytest

from test_torch_runtime_loader import FIXTURES, load_core_tests

_PLAN = ("asserts RLHFConfig.learner_plan(), a ParallelPlan of "
         "parallel/plan.py, which is not ported (ROADMAP Queue 1 item 9); "
         "its twin below holds the rest of the body and that "
         "learner_plan raises")

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_anakin_lowers_to_one_packed_shared_slice": _PLAN,
    "test_sebulba_lowers_to_spread_rollout_and_train_slices": _PLAN,
    "test_placement_reserve_release_against_live_slice_manager":
        "drives a live SliceManager of autoscaler/slices.py, which is not "
        "ported (ROADMAP Queue 1 item 9); "
        "test_reserve_is_all_or_nothing_with_rollback holds reserve and "
        "release against a stub manager",
}

globals().update(FIXTURES)
globals().update(load_core_tests("rlhf/test_config.py", LEAVE_OUT))


def test_anakin_lowers_to_one_packed_shared_slice_but_no_plan():
    cfg = RLHFConfig(placement="anakin", num_learners=2, num_engines=3)
    assert cfg.slice_strategy == "SLICE_PACK"
    p = cfg.lower()
    assert p.num_slices == 1
    assert p.groups == [{"role": "shared", "engines": 3,
                         "learners": 2}]
    assert p.slice_strategy == "SLICE_PACK"
    with pytest.raises(NotImplementedError, match="item 9"):
        cfg.learner_plan()


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
    with pytest.raises(NotImplementedError, match="item 9"):
        cfg.learner_plan()
    assert cfg.model_config() == {"dtype": "float32"}
