"""The JAX package's ``tests/rlhf/test_rlhf_chaos.py`` bodies on the
port (loaded by ``tests/test_torch_runtime_loader.py``): rollout
generator tasks on the port's runtime, and weight syncs raced against
decode on the port's engine. The file's ``_tiny_params`` draws the JAX
package's weights of the seed and hands them over as numpy, the form
the port's rollout engine and ``pack_weights`` take."""

from test_torch_runtime_loader import (FIXTURES, RLHF_ON_THE_CPU,
                                       load_core_tests)


def numpy_tiny_params(seed=0):
    import jax
    import numpy as np

    from ray_tpu.models import TransformerConfig, init_params
    from ray_tpu.serve.llm_engine import _resolve_dtype
    m = dict(MODEL)
    m["dtype"] = _resolve_dtype(m["dtype"])
    return jax.tree.map(np.asarray, init_params(
        TransformerConfig(**m), jax.random.PRNGKey(seed)))


globals().update(FIXTURES)
globals().update(RLHF_ON_THE_CPU)
globals().update(load_core_tests("rlhf/test_rlhf_chaos.py",
                                 replace={"_tiny_params": numpy_tiny_params}))
