"""The JAX package's ``tests/rllib/test_rollout_stream.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): ``RandomEnv``,
the deterministic generator body, the fan-in stream, the learner group's
streamed epoch and PPO's streamed step. The bodies draw a module's
weights from ``jax.random.PRNGKey(0)``; on the port ``init`` takes the
seed."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

EDITS = (("    import jax\n", ""),
         ("init(jax.random.PRNGKey(0))", "init(0)"))

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_rollout_stream.py",
                                 edits=EDITS))
