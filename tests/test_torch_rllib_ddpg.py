"""rllib's DDPG and TD3 learners against the JAX package's, on the CPU in
f32 at 1e-5, each port learner holding the JAX learner's state
(``_bridge.offpolicy_state_from_jax``) and TD3's fed JAX's own smoothing
draws (the key split of JAX's ``_update``).

Held, for 20 updates each: every update's metrics, then the policy, the
critic(s), both polyak targets and both optimizers' counts and moments.
TD3's delayed policy step: across an odd update the policy, its Adam
state and its target stay as they were while the critics' target moves;
across an even one all have moved. ``update_many`` against the scanned
burst, and the exploration runner at equal weights.
"""

import jax
import numpy as np
import pytest

from ray_tpu.rllib.ddpg import DDPGEnvRunner as JaxRunner
from ray_tpu.rllib.ddpg import DDPGLearner as JaxDDPG
from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec

from ray_tpu_torch.rllib.ddpg import DDPGEnvRunner, DDPGLearner
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from test_torch_rllib_dqn import (BATCH, BOX, carried, close, np_tree,
                                  run_updates, stacked, states_close,
                                  transitions, trees_close)

KW = dict(actor_lr=3e-3, critic_lr=3e-3, gamma=0.97, tau=0.05,
          grad_clip=0.5, seed=0)
TD3 = dict(twin_q=True, policy_delay=2, smooth_target_noise=0.2,
           smooth_target_clip=0.5)


def td3_noise(key, batch_size, action_dim=BOX["action_dim"]):
    """JAX's smoothing draw of one update from ``key``: (noise, the key
    it carries on)."""
    key, k_noise = jax.random.split(key)
    return ({"target": np.asarray(jax.random.normal(
        k_noise, (batch_size, action_dim)))}, key)


@pytest.mark.parametrize("variant", ["ddpg", "td3"])
def test_twenty_updates_match_jax(variant):
    kw = dict(KW, **(TD3 if variant == "td3" else {}))
    jl = JaxDDPG(JaxSpec(**BOX), **kw)
    tl = carried(jl, DDPGLearner, BOX, **kw)
    noise_of = (lambda st, b: td3_noise(st["key"], b)[0]) \
        if variant == "td3" else None
    run_updates(jl, tl, noise_of, spec=BOX)
    states_close(tl, jl)
    assert tl.state_numpy()["pi_opt"]["count"] == \
        (10 if variant == "td3" else 20)


def test_td3_delays_the_policy_step():
    tl = DDPGLearner(RLModuleSpec(**BOX), **KW, **TD3, device="cpu")
    rng = np.random.default_rng(1)
    states = [tl.state_numpy()]
    for _ in range(4):
        tl.update(transitions(rng, BOX))
        states.append(tl.state_numpy())
    for i in (1, 3):                         # odd updates: the policy waits
        prev, cur = states[i - 1], states[i]
        trees_close(cur["pi"], prev["pi"], 0)
        trees_close(cur["pi_t"], prev["pi_t"], 0)
        trees_close(cur["pi_opt"], prev["pi_opt"], 0)
        with pytest.raises(AssertionError):
            trees_close(cur["qs_t"], prev["qs_t"], 0)
    for i in (2, 4):                         # even updates: it steps
        prev, cur = states[i - 1], states[i]
        assert cur["pi_opt"]["count"] == prev["pi_opt"]["count"] + 1
        for k in ("pi", "pi_t"):
            with pytest.raises(AssertionError):
                trees_close(cur[k], prev[k], 0)
        tau = KW["tau"]
        want = jax.tree.map(lambda t, o: (1 - tau) * t + tau * o,
                            prev["pi_t"], cur["pi"])
        trees_close(cur["pi_t"], want, 1e-6)


def test_update_many_matches_the_scanned_burst():
    kw = dict(KW, **TD3)
    jl = JaxDDPG(JaxSpec(**BOX), **kw)
    tl = carried(jl, DDPGLearner, BOX, **kw)
    batches = stacked(np.random.default_rng(2), BOX, 5)
    key, draws = jl._state["key"], []
    for _ in range(5):
        n, key = td3_noise(key, BATCH)
        draws.append(n["target"])
    jm = jl.update_many(batches)
    tm = tl.update_many(batches, noise={"target": np.stack(draws)})
    for k in jm:
        close(tm[k], jm[k])
    states_close(tl, jl)


def test_exploration_runner_equals_jax_at_equal_weights():
    """The deterministic policy plus Gaussian noise from the same numpy
    generator, clipped into (-1, 1): equal actions and transitions."""
    jl = JaxDDPG(JaxSpec(**BOX), **KW)

    class Env:
        observation_space = type("S", (), {"shape": (3,)})()

        def __init__(self):
            self.rng = np.random.default_rng(4)

        def reset(self, seed=None):
            return self.rng.normal(size=3).astype(np.float32), {}

        def step(self, action):
            return (self.rng.normal(size=3).astype(np.float32),
                    float(np.sum(action)), False, False, {})

    jr = JaxRunner(Env, JaxSpec(**BOX), num_envs=2, seed=2, noise_sigma=0.3)
    tr = DDPGEnvRunner(Env, RLModuleSpec(**BOX), num_envs=2, seed=2,
                       noise_sigma=0.3)
    jr.set_weights(jl.get_weights())
    tr.set_weights(np_tree(jl.get_weights()))
    jb, tb = jr.sample(10, 0.0), tr.sample(10, 0.0)
    for k in jb:
        close(tb[k], jb[k], 1e-6)
