"""The JAX package's ``tests/core/test_fault_tolerance.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``). The two
MPMD pipeline kill bodies (slow-marked, as in the JAX package) build
their model with a torch dtype where the JAX body names ``jnp.float32``,
and the rollout-stream kill body draws its module's weights from a seed
where the JAX body passes ``jax.random.PRNGKey(0)``."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: the model configs of the MPMD bodies: a torch dtype for JAX's; the
#: rollout stream's weights from the seed
EDITS = (("import jax.numpy as jnp", "import torch"),
         ("dtype=jnp.float32", "dtype=torch.float32"),
         ('init(__import__("jax").random.PRNGKey(0))', "init(0)"))

globals().update(FIXTURES)
globals().update(load_core_tests("test_fault_tolerance.py", edits=EDITS))
