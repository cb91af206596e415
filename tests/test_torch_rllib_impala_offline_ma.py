"""The on-policy bodies of the JAX package's
``tests/rllib/test_impala_offline_ma.py`` on the port (loaded by
``tests/test_torch_runtime_loader.py``): V-trace (on tensors where the
body passes ``jnp`` arrays), the connectors, and, ``slow``-marked as in
the JAX package, IMPALA on CartPole and multi-agent PPO."""

from test_torch_runtime_loader import (FIXTURES, RLLIB_ON_THE_CPU,
                                       load_core_tests)

_OFFLINE = "reads rllib/offline.py (BC, MARWIL, JsonReader/Writer), the " \
    "next slice (ROADMAP Queue 1 item 10)"

#: bodies left out, each with its reason
LEAVE_OUT = {
    "cartpole_offline_data": _OFFLINE,
    "test_json_reader_roundtrip": _OFFLINE,
    "test_bc_clones_expert": _OFFLINE,
    "test_marwil_learns_from_offline": _OFFLINE,
}

#: the offline names leave the import (they raise on access), and the
#: V-trace body's ``jnp`` arrays become tensors
EDITS = (("    BC, BCConfig, IMPALA, IMPALAConfig, JsonReader, JsonWriter,\n"
          "    MARWIL, MARWILConfig, MultiAgentEnv, MultiAgentPPO,",
          "    IMPALA, IMPALAConfig, MultiAgentEnv, MultiAgentPPO,"),
         ("    import jax.numpy as jnp\n", "    import torch\n"),
         ("jnp.asarray(", "torch.as_tensor("))

globals().update(FIXTURES)
globals().update(RLLIB_ON_THE_CPU)
globals().update(load_core_tests("rllib/test_impala_offline_ma.py",
                                 LEAVE_OUT, edits=EDITS))
