"""The JAX package's ``tests/rllib/test_ddpg_cql_estimators.py`` bodies
on the port (loaded by ``tests/test_torch_runtime_loader.py``): DDPG
refusing a Discrete space, CQL refusing to start without offline data,
and the estimators (IS recovering the behaviour value when the policies
match, IS and WIS ranking a better policy higher, DM and DR over an FQE
model); ``slow``-marked as in the JAX package, DDPG's and TD3's
iterations on Pendulum and CQL trained from an offline dataset, the
learners on the CPU."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_ddpg_cql_estimators.py"))
