"""The JAX package's ``tests/rllib/test_continuous.py`` bodies on the port
(loaded by ``tests/test_torch_runtime_loader.py``): the squashed
Gaussian's log-density against the change of variables and the diagonal
Gaussian's entropy (on tensors, the sample from a ``torch.Generator``,
where the bodies use ``jax``), DQN refusing a Box space, and,
``slow``-marked as in the JAX package, Gaussian PPO and continuous SAC on
Pendulum."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

EDITS = (("    import jax\n    import jax.numpy as jnp\n"
          "    key = jax.random.PRNGKey(0)",
          "    import torch\n    key = torch.Generator().manual_seed(0)"),
         ("    import jax.numpy as jnp\n    log_std = jnp.zeros((4, 3))",
          "    import torch\n    log_std = torch.zeros((4, 3))"),
         ("jnp.asarray(", "torch.tensor("))

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_continuous.py", edits=EDITS))
