"""The JAX package's ``tests/rlhf/test_e2e.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``), and one closed loop
that is not ``slow``: the JAX file's anakin acceptance body, one round
with 2 remote learners on the port's CPU runtime. Each round's prefix
figures are printed (``pytest -rP`` shows them): its hit rate, prompt
blocks and the blocks its engines prefilled again at weight swaps."""

import json

import pytest
from test_torch_runtime_loader import (FIXTURES, RLHF_ON_THE_CPU,
                                       load_core_tests)

globals().update(FIXTURES)
globals().update(RLHF_ON_THE_CPU)
globals().update(load_core_tests("rlhf/test_e2e.py"))


@pytest.fixture(autouse=True)
def _print_rounds(monkeypatch):
    from ray_tpu_torch.rlhf.trainer import RLHFTrainer
    train_round = RLHFTrainer.train_round

    def printed(self):
        out = train_round(self)
        print("rlhf round " + json.dumps({k: out[k] for k in (
            "round", "prefix_hit_rate", "prompt_blocks_total",
            "rewarm_blocks", "weight_syncs")}))
        return out

    monkeypatch.setattr(RLHFTrainer, "train_round", printed)


def test_anakin_closed_loop_one_round_on_the_port(rlhf_cluster):
    """``test_anakin_closed_loop_meets_acceptance`` (``slow`` in the JAX
    file) run as it stands: one anakin round with 2 remote learners
    meets every acceptance bar of the JAX body on the port."""
    test_anakin_closed_loop_meets_acceptance(rlhf_cluster)
