"""The PPO and APPO bodies of the JAX package's
``tests/rllib/test_learning_thresholds.py`` on the port (loaded by
``tests/test_torch_runtime_loader.py``), ``slow``-marked as in the JAX
package: PPO and APPO reach the reference's CartPole bar, and APPO's one
structural iteration."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_sac_cartpole_learns":
        "reads rllib/sac.py, the next slice (ROADMAP Queue 1 item 10)",
}

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_learning_thresholds.py",
                                 LEAVE_OUT))
