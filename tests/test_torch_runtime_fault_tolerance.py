"""The JAX package's ``tests/core/test_fault_tolerance.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``). The two
MPMD pipeline kill bodies (slow-marked, as in the JAX package) build
their model with a torch dtype where the JAX body names ``jnp.float32``."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_rollout_stream_midepoch_kill_exactly_once":
        "reads rllib (ROADMAP Queue 1 item 10)",
}

#: the model configs of the MPMD bodies: a torch dtype for JAX's
EDITS = (("import jax.numpy as jnp", "import torch"),
         ("dtype=jnp.float32", "dtype=torch.float32"))

globals().update(FIXTURES)
globals().update(load_core_tests("test_fault_tolerance.py", LEAVE_OUT,
                                 edits=EDITS))
