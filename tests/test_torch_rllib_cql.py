"""rllib's CQL learner against the JAX package's, on the CPU in f32 at
1e-5: the port learner holds the JAX learner's state
(``_bridge.offpolicy_state_from_jax``) and is fed JAX's own draws, taken
with the key splits of JAX's ``_update`` (the next action's and the
policy loss's standard normals, the N uniform actions, the N policy
samples' normals).

Held, for 20 updates: every update's metrics (the TD and CQL(H) terms
apart), then every network, target and optimizer state; ``update_many``
against the scanned burst; and the penalty's value on its own against a
numpy evaluation of the formula (a logsumexp over the 2N importance-
corrected samples less log 2N, less Q on the dataset's actions).
"""

import math

import jax
import numpy as np
import torch

from ray_tpu.rllib.cql import CQLLearner as JaxCQL
from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec

from ray_tpu_torch.rllib.cql import CQLLearner
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.sac import q_value
from test_torch_rllib_dqn import (BATCH, BOX, carried, close, run_updates,
                                  stacked, states_close, transitions)

N = 3
KW = dict(cql_alpha=0.7, cql_n_actions=N, actor_lr=3e-3, critic_lr=3e-3,
          alpha_lr=3e-3, gamma=0.97, tau=0.05, target_entropy=None,
          grad_clip=0.5, seed=0)


def cql_noise(key, batch_size, n=N, action_dim=BOX["action_dim"]):
    """JAX's draws of one CQL update from ``key``: (noise, the key it
    carries on)."""
    key, k_next, k_pi, k_rand, k_cur = jax.random.split(key, 5)
    shape = (batch_size, action_dim)
    cur = [jax.random.normal(k, shape) for k in jax.random.split(k_cur, n)]
    return ({"next": np.asarray(jax.random.normal(k_next, shape)),
             "pi": np.asarray(jax.random.normal(k_pi, shape)),
             "rand": np.asarray(jax.random.uniform(
                 k_rand, (n,) + shape, minval=-1.0, maxval=1.0)),
             "cur": np.stack([np.asarray(c) for c in cur])}, key)


def test_twenty_updates_match_jax():
    jl = JaxCQL(JaxSpec(**BOX), **KW)
    tl = carried(jl, CQLLearner, BOX, **KW)
    jm, _ = run_updates(jl, tl, lambda st, b: cql_noise(st["key"], b)[0],
                        spec=BOX)
    assert jm["cql_loss"] != 0.0
    states_close(tl, jl)


def test_update_many_matches_the_scanned_burst():
    jl = JaxCQL(JaxSpec(**BOX), **KW)
    tl = carried(jl, CQLLearner, BOX, **KW)
    batches = stacked(np.random.default_rng(1), BOX, 4)
    key, draws = jl._state["key"], []
    for _ in range(4):
        n, key = cql_noise(key, BATCH)
        draws.append(n)
    noise = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
    jm, tm = jl.update_many(batches), tl.update_many(batches, noise=noise)
    for k in jm:
        close(tm[k], jm[k])
    states_close(tl, jl)


def test_penalty_is_the_cql_h_term():
    tl = CQLLearner(RLModuleSpec(**BOX), **KW, device="cpu")
    b = transitions(np.random.default_rng(2), BOX, 8)
    noise, _ = cql_noise(jax.random.PRNGKey(3), 8)
    t = {k: torch.tensor(v) for k, v in b.items()}
    rand = torch.tensor(noise["rand"])
    pol = torch.tensor(noise["cur"]).tanh()
    logp = torch.tensor(np.random.default_rng(4).normal(size=(N, 8)),
                        dtype=torch.float32)
    q1 = tl._state["q1"]
    with torch.no_grad():
        got = float(tl._penalty(q1, t["obs"], t["actions"], rand, pol, logp))
        qr = np.stack([q_value(q1, t["obs"], a).numpy() for a in rand])
        qp = np.stack([q_value(q1, t["obs"], a).numpy() for a in pol])
        qd = q_value(q1, t["obs"], t["actions"]).numpy()
    stacked_ = np.concatenate([qr - 2 * math.log(0.5),
                               qp - logp.numpy()]).astype(np.float64)
    m = stacked_.max(0)
    lse = m + np.log(np.exp(stacked_ - m).sum(0)) - math.log(2 * N)
    close(got, np.mean(lse - qd))
