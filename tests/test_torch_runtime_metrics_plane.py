"""The JAX package's ``tests/core/test_metrics_plane.py`` bodies on the
port's runtime (loaded by ``tests/test_torch_runtime_loader.py``)."""

from test_torch_runtime_loader import FIXTURES, load_core_tests

#: bodies left out, each with its reason
LEAVE_OUT = {
    "test_reporter_roundtrip_and_drop_oldest_accounting":
        "a load-sensitive timing floor that fails in whole runs of the "
        "JAX package under xdist (ROADMAP Queue 3)",
}

#: the fleet body's engine actor builds a JAX engine: it builds the
#: port's, in f32 on the CPU, instead
PORT_ENGINE = [("import jax.numpy as jnp\n", "import torch as jnp\n"),
               ("max_new_tokens=8))\n",
                "max_new_tokens=8), device=\"cpu\")\n")]

globals().update(FIXTURES)
globals().update(load_core_tests("test_metrics_plane.py", LEAVE_OUT,
                                 edits=PORT_ENGINE))
