"""The JAX package's ``tests/rllib/test_learning_thresholds.py`` bodies on
the port (loaded by ``tests/test_torch_runtime_loader.py``),
``slow``-marked as in the JAX package: PPO, APPO and discrete SAC reach
the reference's CartPole bars, and APPO's one structural iteration."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_learning_thresholds.py"))
