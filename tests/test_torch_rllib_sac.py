"""rllib's SAC learners against the JAX package's, on the CPU in f32 at
1e-5, each port learner holding the JAX learner's state
(``_bridge.offpolicy_state_from_jax``).

Held, for 20 updates each: the discrete learner (expectations over the
categorical policy, nothing drawn) and the continuous one, which is fed
JAX's own draws, taken with the key splits of JAX's ``_update`` (the
next action's and the policy loss's standard normals): every update's
metrics, then the policy, both critics and their polyak targets,
``log_alpha`` and the three optimizers' counts and moments. The critics
share one optimizer, so the global-norm clip spans both nets. Also
``update_many`` against the scanned burst, the targets' polyak step, and
the discrete runner's policy draws at equal weights.
"""

import jax
import numpy as np
import pytest

from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rllib.rollout_stream import RandomEnv as JaxRandomEnv
from ray_tpu.rllib.sac import ContinuousSACLearner as JaxContinuous
from ray_tpu.rllib.sac import SACEnvRunner as JaxSACRunner
from ray_tpu.rllib.sac import SACLearner as JaxDiscrete

from ray_tpu_torch.rllib import RandomEnv
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.sac import (ContinuousSACLearner, SACEnvRunner,
                                     SACLearner)
from test_torch_rllib_dqn import (BATCH, BOX, DISCRETE, carried, close,
                                  np_tree, run_updates, stacked,
                                  states_close, trees_close)

KW = dict(actor_lr=3e-3, critic_lr=3e-3, alpha_lr=3e-3, gamma=0.97,
          tau=0.05, target_entropy=None, grad_clip=0.5, seed=0)


def sac_noise(key, batch_size, action_dim=BOX["action_dim"]):
    """JAX's draws of one continuous update from ``key``: (noise, the
    key it carries on)."""
    key, k_next, k_pi = jax.random.split(key, 3)
    shape = (batch_size, action_dim)
    return ({"next": np.asarray(jax.random.normal(k_next, shape)),
             "pi": np.asarray(jax.random.normal(k_pi, shape))}, key)


def test_discrete_sac_twenty_updates_match_jax():
    jl = JaxDiscrete(JaxSpec(**DISCRETE), **KW)
    tl = carried(jl, SACLearner, DISCRETE, **KW)
    run_updates(jl, tl)
    states_close(tl, jl)


def test_continuous_sac_twenty_updates_match_jax():
    jl = JaxContinuous(JaxSpec(**BOX), **KW)
    tl = carried(jl, ContinuousSACLearner, BOX, **KW)
    jm, _ = run_updates(jl, tl, lambda st, b: sac_noise(st["key"], b)[0],
                        spec=BOX)
    assert jm["alpha"] != 1.0
    states_close(tl, jl)


def test_continuous_update_many_matches_the_scanned_burst():
    jl = JaxContinuous(JaxSpec(**BOX), **KW)
    tl = carried(jl, ContinuousSACLearner, BOX, **KW)
    batches = stacked(np.random.default_rng(1), BOX, 6)
    key, draws = jl._state["key"], []
    for _ in range(6):
        n, key = sac_noise(key, BATCH)
        draws.append(n)
    noise = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
    jm, tm = jl.update_many(batches), tl.update_many(batches, noise=noise)
    for k in jm:
        close(tm[k], jm[k])
    states_close(tl, jl)


@pytest.mark.parametrize("cls,spec", [(SACLearner, DISCRETE),
                                      (ContinuousSACLearner, BOX)])
def test_targets_take_the_polyak_step_toward_the_updated_critics(cls, spec):
    tl = cls(RLModuleSpec(**spec), **dict(KW, seed=3), device="cpu")
    b = stacked(np.random.default_rng(2), spec, 2)
    tl.update({k: v[0] for k, v in b.items()})
    before = tl.state_numpy()
    tl.update({k: v[1] for k, v in b.items()})
    after = tl.state_numpy()
    tau = KW["tau"]
    for q in ("q1", "q2"):
        want = jax.tree.map(lambda t, o: (1 - tau) * t + tau * o,
                            before[q + "_t"], after[q])
        trees_close(after[q + "_t"], want, 1e-6)


def test_update_many_draws_as_single_updates_do():
    """Without noise given, a burst of K draws from the generator in the
    order K single updates do."""
    a = ContinuousSACLearner(RLModuleSpec(**BOX), **KW, device="cpu")
    b = ContinuousSACLearner(RLModuleSpec(**BOX), **KW, device="cpu")
    batches = stacked(np.random.default_rng(5), BOX, 4)
    ma = a.update_many(batches)
    for i in range(4):
        mb = b.update({k: v[i] for k, v in batches.items()})
    assert ma == mb
    trees_close(a.state_numpy(), b.state_numpy(), 0)


def test_discrete_runner_draws_as_jax_at_equal_weights():
    """The categorical draw is the JAX runner's: the softmax's cumulative
    sum against the same numpy generator."""
    jl = JaxDiscrete(JaxSpec(**DISCRETE), **KW)
    jr = JaxSACRunner(lambda: JaxRandomEnv(4, 3, 9), JaxSpec(**DISCRETE),
                      num_envs=2, seed=1, worker_index=0)
    tr = SACEnvRunner(lambda: RandomEnv(4, 3, 9), RLModuleSpec(**DISCRETE),
                      num_envs=2, seed=1, worker_index=0)
    jr.set_weights(jl.get_weights())
    tr.set_weights(np_tree(jl.get_weights()))
    jb, tb = jr.sample(16), tr.sample(16)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
