"""rllib's off-policy estimators against the JAX package's, on the CPU at
1e-5: IS and WIS (numpy in both packages) on the same episodes and
policies; the FQE model from the JAX model's weights
(``FQEModel.load_params``) through 200 Adam iterations on the same
minibatches (drawn from ``default_rng(seed)`` in both), its loss and
weights; DM and DR over the two trained models.
"""

import numpy as np

from ray_tpu.rllib.estimators import DirectMethod as JaxDM
from ray_tpu.rllib.estimators import DoublyRobust as JaxDR
from ray_tpu.rllib.estimators import FQEModel as JaxFQE
from ray_tpu.rllib.estimators import ImportanceSampling as JaxIS
from ray_tpu.rllib.estimators import \
    WeightedImportanceSampling as JaxWIS
from ray_tpu.rllib.estimators import split_episodes as jax_split

from ray_tpu_torch.rllib import (DirectMethod, DoublyRobust, FQEModel,
                                 ImportanceSampling,
                                 WeightedImportanceSampling)
from ray_tpu_torch.rllib.estimators import split_episodes
from ray_tpu_torch.rllib.models import tree_to_numpy
from test_torch_rllib_dqn import close, np_tree, trees_close


def chain_batch(n_eps=30, T=6, seed=0, behavior_p=0.5):
    """The JAX test's two-action chain: action 1 pays 1, action 0 pays
    0; the behaviour policy picks 1 with ``behavior_p``; the last
    episode is cut short (no done)."""
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in ("obs", "next_obs", "actions", "rewards",
                            "dones", "logp")}
    for e in range(n_eps):
        for t in range(T - 2 if e == n_eps - 1 else T):
            a = int(rng.random() < behavior_p)
            rows["obs"].append([t / T])
            rows["next_obs"].append([(t + 1) / T])
            rows["actions"].append(a)
            rows["rewards"].append(float(a))
            rows["dones"].append(float(t == T - 1))
            rows["logp"].append(np.log(behavior_p if a else 1 - behavior_p))
    return {"obs": np.asarray(rows["obs"], np.float32),
            "next_obs": np.asarray(rows["next_obs"], np.float32),
            "actions": np.asarray(rows["actions"]),
            "rewards": np.asarray(rows["rewards"], np.float32),
            "dones": np.asarray(rows["dones"], np.float32),
            "logp": np.asarray(rows["logp"], np.float32)}


def logp_fn(p1):
    return lambda obs, actions: np.where(np.asarray(actions) == 1,
                                         np.log(p1), np.log(1 - p1))


def probs_fn(p1):
    return lambda obs: np.tile([1 - p1, p1], (len(obs), 1))


def test_split_episodes():
    b = chain_batch()
    got, want = split_episodes(b), jax_split(b)
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_is_and_wis_match_jax():
    b = chain_batch(seed=1)
    for p1 in (0.5, 0.8, 0.2):
        for cls, jcls in ((ImportanceSampling, JaxIS),
                          (WeightedImportanceSampling, JaxWIS)):
            got = cls(logp_fn(p1), gamma=0.95).estimate(b)
            want = jcls(logp_fn(p1), gamma=0.95).estimate(b)
            assert got["num_episodes"] == want["num_episodes"]
            close(got["v_target"], want["v_target"])
            close(got["v_behavior"], want["v_behavior"])


def test_fqe_dm_and_dr_match_jax():
    """200 FQE iterations from the JAX model's weights on the same
    minibatches (minibatch 64 of 178 rows), then DM and DR."""
    b = chain_batch(seed=2)
    kw = dict(obs_dim=1, num_actions=2, target_probs_fn=probs_fn(0.8),
              gamma=0.9, lr=3e-3, hiddens=(16, 16), seed=0)
    jf, tf = JaxFQE(**kw), FQEModel(**kw, device="cpu")
    tf.load_params(np_tree(jf._params))
    jl = jf.train(b, iters=200, minibatch=64, seed=3)
    tl = tf.train(b, iters=200, minibatch=64, seed=3)
    close(tl, jl)
    trees_close(tree_to_numpy(tf._params), np_tree(jf._params))
    close(tf.q_values(b["obs"]), jf.q_values(b["obs"]))
    close(DirectMethod(tf).estimate(b)["v_target"],
          JaxDM(jf).estimate(b)["v_target"])
    got = DoublyRobust(tf, logp_fn(0.8), gamma=0.9).estimate(b)
    want = JaxDR(jf, logp_fn(0.8), gamma=0.9).estimate(b)
    assert got["num_episodes"] == want["num_episodes"]
    close(got["v_target"], want["v_target"])
