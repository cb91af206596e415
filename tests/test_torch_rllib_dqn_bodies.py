"""The JAX package's ``tests/rllib/test_dqn.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``): the replay buffer's
ring and, ``slow``-marked as in the JAX package, DQN learning CartPole
and its checkpoint round trip, the learner on the CPU."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_dqn.py"))
