"""The JAX package's ``tests/rllib/test_impala_offline_ma.py`` bodies on
the port (loaded by ``tests/test_torch_runtime_loader.py``): V-trace (on
tensors where the body passes ``jnp`` arrays), the connectors, the JSON
reader over an expert's CartPole episodes, and, ``slow``-marked as in the
JAX package, IMPALA on CartPole, BC cloning the expert, MARWIL learning
from its data and multi-agent PPO."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

#: the V-trace body's ``jnp`` arrays become tensors
EDITS = (("    import jax.numpy as jnp\n", "    import torch\n"),
         ("jnp.asarray(", "torch.as_tensor("))

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_impala_offline_ma.py",
                                 edits=EDITS))
