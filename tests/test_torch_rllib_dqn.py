"""rllib's DQN against the JAX package's, on the CPU in f32 at 1e-5.

A port learner takes the JAX learner's whole state (params, target
params, the optax ``clip_by_global_norm -> adam`` moments and the step
count) through ``_bridge.offpolicy_state_from_jax``. Held: 20 updates
with double-Q on and off, the target synced every 5 updates and the clip
acting: every update's metrics, then the params, the targets and the
optimizer state; ``update_many`` against the JAX package's scanned burst
(``_scanned_update``); the replay buffer's samples for a seed; the env
runner's transitions at equal weights (epsilon-greedy draws from the
same numpy generator). The helpers here serve the other off-policy
parity files (``tests/test_torch_rllib_{sac,ddpg,cql}.py``).
"""

import jax
import numpy as np
import pytest

from ray_tpu.rllib.dqn import DQNEnvRunner as JaxDQNRunner
from ray_tpu.rllib.dqn import DQNLearner as JaxDQNLearner
from ray_tpu.rllib.dqn import ReplayBuffer as JaxReplayBuffer
from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rllib.rollout_stream import RandomEnv as JaxRandomEnv

from ray_tpu_torch._bridge import offpolicy_state_from_jax
from ray_tpu_torch.rllib import RandomEnv
from ray_tpu_torch.rllib.dqn import DQNEnvRunner, DQNLearner, ReplayBuffer
from ray_tpu_torch.rllib.rl_module import RLModuleSpec

TOL = 1e-5
UPDATES = 20
BATCH = 32
DISCRETE = dict(observation_dim=4, num_actions=3, hiddens=(16, 16))
BOX = dict(observation_dim=3, dist="squashed_gaussian", action_dim=2,
           action_low=(-1.0, -1.0), action_high=(1.0, 1.0),
           hiddens=(16, 16))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def trees_close(got, want, tol=TOL):
    """Trees of the same structure (numpy leaves), leaf by leaf."""
    got, want = np_tree(got), np_tree(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        close(g, w, tol)


def carried(jax_learner, port_cls, spec, **kw):
    """A port learner on the CPU holding the JAX learner's state."""
    tl = port_cls(RLModuleSpec(**spec), **kw, device="cpu")
    tl.load_state(offpolicy_state_from_jax(np_tree(jax_learner._state),
                                           "cpu"))
    return tl


def states_close(port_learner, jax_learner, tol=TOL):
    """Every key of the two states: the networks, each optimizer's
    count and moments, the step count."""
    from ray_tpu_torch._bridge import _find_adam_state
    got = port_learner.state_numpy()
    want = np_tree(jax_learner._state)
    assert set(got) == set(want) - {"key"}
    for k, v in got.items():
        if k == "steps":
            assert v == int(want[k]), k
        elif k in port_learner.OPTS:
            adam = _find_adam_state(want[k])
            assert v["count"] == int(adam.count), k
            trees_close(v["mu"], adam.mu, tol)
            trees_close(v["nu"], adam.nu, tol)
        else:
            trees_close(v, want[k], tol)


def transitions(rng, spec, n=BATCH):
    """A seeded minibatch of transitions for ``spec``'s spaces (Box
    actions in (-1, 1), as the replay buffer stores them)."""
    obs_dim = spec["observation_dim"]
    if spec.get("action_dim"):
        acts = rng.uniform(-0.95, 0.95,
                           (n, spec["action_dim"])).astype(np.float32)
    else:
        acts = rng.integers(0, spec["num_actions"], n)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": acts,
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32)}


def run_updates(jl, tl, noise_of=None, updates=UPDATES, spec=DISCRETE,
                seed=0):
    """``updates`` single updates of both learners on fresh seeded
    minibatches, the port fed JAX's draws (``noise_of(jax_state, B)``,
    taken before the JAX update consumes its key); every update's
    metrics agree. Returns the last update's metrics of each."""
    rng = np.random.default_rng(seed)
    jm = tm = None
    for _ in range(updates):
        b = transitions(rng, spec)
        noise = None if noise_of is None else noise_of(jl._state, BATCH)
        jm, tm = jl.update(b), tl.update(b, noise=noise)
        assert set(jm) == set(tm)
        for k in jm:
            close(tm[k], jm[k])
    return jm, tm


def stacked(rng, spec, k):
    bs = [transitions(rng, spec) for _ in range(k)]
    return {name: np.stack([b[name] for b in bs]) for name in bs[0]}


def jax_dqn(double_q=True, clip=0.5, seed=0):
    return JaxDQNLearner(JaxSpec(**DISCRETE), learning_rate=1e-2,
                         gamma=0.97, grad_clip=clip, target_update_freq=5,
                         double_q=double_q, seed=seed)


DQN_KW = dict(learning_rate=1e-2, gamma=0.97, grad_clip=0.5,
              target_update_freq=5, seed=0)


@pytest.mark.parametrize("double_q", [True, False])
def test_twenty_updates_match_jax(double_q):
    """20 updates, the target synced every 5 (after the count is
    incremented) and the clip acting in the first ones."""
    jl = jax_dqn(double_q)
    tl = carried(jl, DQNLearner, DISCRETE, double_q=double_q, **DQN_KW)
    rng = np.random.default_rng(1)
    clipped = 0
    for _ in range(UPDATES):
        b = transitions(rng, DISCRETE)
        jm, tm = jl.update(b), tl.update(b)
        clipped += jm["grad_norm"] > 0.5
        for k in jm:
            close(tm[k], jm[k])
    assert clipped
    states_close(tl, jl)
    assert tl.state_numpy()["steps"] == UPDATES


def test_target_is_synced_after_the_step_count_moves():
    """The target equals the online params bit for bit right after
    update 5, and stays at them through update 6 while the online params
    move."""
    jl = jax_dqn()
    tl = carried(jl, DQNLearner, DISCRETE, double_q=True, **DQN_KW)
    rng = np.random.default_rng(2)
    for i in range(6):
        tl.update(transitions(rng, DISCRETE))
        s = tl.state_numpy()
        if i == 3:
            before = s["target_params"]
        if i == 4:
            trees_close(s["target_params"], s["params"], 0)
            synced = s["target_params"]
    trees_close(s["target_params"], synced, 0)
    with pytest.raises(AssertionError):
        trees_close(s["params"], synced, 0)
    with pytest.raises(AssertionError):
        trees_close(before, synced, 0)


def test_update_many_matches_the_scanned_burst():
    """``update_many`` over [K, B, ...] minibatches against JAX's
    ``lax.scan`` burst: the last update's metrics and the whole state."""
    jl = jax_dqn()
    tl = carried(jl, DQNLearner, DISCRETE, double_q=True, **DQN_KW)
    batches = stacked(np.random.default_rng(3), DISCRETE, 8)
    jm, tm = jl.update_many(batches), tl.update_many(batches)
    for k in jm:
        close(tm[k], jm[k])
    states_close(tl, jl)


def test_update_many_equals_single_updates():
    tl = DQNLearner(RLModuleSpec(**DISCRETE), double_q=True, device="cpu",
                    **DQN_KW)
    tl2 = DQNLearner(RLModuleSpec(**DISCRETE), double_q=True, device="cpu",
                     **DQN_KW)
    batches = stacked(np.random.default_rng(4), DISCRETE, 8)
    tm = tl.update_many(batches)
    for i in range(8):
        m = tl2.update({k: v[i] for k, v in batches.items()})
    assert m == tm
    trees_close(tl.state_numpy(), tl2.state_numpy(), 0)


def test_replay_buffer_samples_equal_for_a_seed():
    args = (64, (3,))
    jb, tb = JaxReplayBuffer(*args, seed=5), ReplayBuffer(*args, seed=5)
    rng = np.random.default_rng(6)
    for _ in range(5):                       # 100 rows: the ring wraps
        b = transitions(rng, dict(DISCRETE, observation_dim=3), 20)
        jb.add_batch(b)
        tb.add_batch(b)
    assert len(jb) == len(tb) == 64
    for got, want in ((tb.sample(16), jb.sample(16)),
                      (tb.sample_many(3, 8), jb.sample_many(3, 8))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_env_runner_transitions_equal_jax_at_equal_weights():
    """``RandomEnv`` ignores the action, and epsilon-greedy draws from the
    same numpy generator with the same greedy argmax: the two runners'
    transitions are equal."""
    jl = jax_dqn()
    spec = dict(DISCRETE, observation_dim=4)
    jr = JaxDQNRunner(lambda: JaxRandomEnv(4, 3, 7), JaxSpec(**spec),
                      num_envs=2, seed=3, worker_index=1)
    tr = DQNEnvRunner(lambda: RandomEnv(4, 3, 7), RLModuleSpec(**spec),
                      num_envs=2, seed=3, worker_index=1)
    jr.set_weights(jl.get_weights())
    tr.set_weights(np_tree(jl.get_weights()))
    for eps in (0.5, 0.0):
        jb, tb = jr.sample(12, eps), tr.sample(12, eps)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tr.episode_returns() == jr.episode_returns()
