"""The JAX package's ``tests/rllib/test_ppo.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``): GAE, a learner's
update, and, ``slow``-marked as in the JAX package, PPO and PG on
CartPole, the checkpoint round trip and two remote learners."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_ppo.py"))
