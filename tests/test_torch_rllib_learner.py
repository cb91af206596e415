"""rllib's ``Learner``, ``EnvRunner`` and ``Checkpoint`` against the JAX
package's, on the CPU in f32 at 1e-5.

A port learner takes the JAX learner's state (params and the optax
``clip_by_global_norm -> adam`` moments) through
``_bridge.rllib_state_from_jax``. Held: a 5-update trajectory through the
learner groups (one 80-row batch in 16-row minibatches, shuffled by the
groups' numpy generators) with the clip active, for a categorical and a
Gaussian policy, each update's metrics and the final params and moments;
20 updates on fresh batches for each of the PPO, PG, IMPALA and APPO
losses from the JAX module's weights (``_bridge.rl_params_from_jax``);
a resume from the JAX state after 2 updates; ``compute_gradients`` and
``apply_gradients``; ``compute_gae`` and the connectors. ``RandomEnv``'s observations, rewards and episode
ends ignore the action, so a runner of either package sees the same
ones: at equal weights its values and GAE advantages equal the JAX
runner's, and the log-probabilities it records equal JAX's
``forward_train`` at the port's own observations and actions (the sampled
actions differ: ``jax.random`` against ``torch.Generator``, ROADMAP Queue
3's standing divergence). Checkpoints written by either package's
``Checkpoint`` read in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.env_runner import EnvRunner as JaxRunner
from ray_tpu.rllib.learner import Learner as JaxLearner
from ray_tpu.rllib.learner import LearnerGroup as JaxGroup
from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec
from ray_tpu.rllib.rollout_stream import RandomEnv as JaxRandomEnv
from ray_tpu.train._checkpoint import Checkpoint as JaxCheckpoint

from ray_tpu_torch._bridge import rl_params_from_jax, rllib_state_from_jax
from ray_tpu_torch.rllib import EnvRunner, Learner, LearnerGroup, RandomEnv
from ray_tpu_torch.rllib.models import tree_leaves, tree_to_numpy
from ray_tpu_torch.rllib.ppo import ppo_loss
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.train import Checkpoint

TOL = 1e-5
CLIP = 0.3          # under every update's gradient norm: the clip acts
LR = 1e-2
SPECS = {"categorical": dict(observation_dim=4, num_actions=3,
                             hiddens=(16, 16)),
         "gaussian": dict(observation_dim=4, dist="gaussian", action_dim=2,
                          action_low=(-1.0, -1.0), action_high=(1.0, 1.0),
                          hiddens=(16, 16))}
LOSS_CONFIG = {"entropy_coeff": 0.01, "vf_clip_param": 2.0}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _trees_close(got, want, tol=TOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w, tol)


def _batch(dist, n=80, seed=0):
    rng = np.random.default_rng(seed)
    actions = rng.normal(size=(n, 2)).astype(np.float32) \
        if dist == "gaussian" else rng.integers(0, 3, n)
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": actions,
            "logp": rng.normal(-1.5, 0.5, n).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": (3 * rng.normal(size=n)).astype(np.float32)}


def _pair(dist, seed=0):
    """A JAX learner and a port learner on the CPU holding its state."""
    jl = JaxLearner(JaxSpec(**SPECS[dist]), jax_ppo_loss, learning_rate=LR,
                    grad_clip=CLIP, seed=seed, loss_config=LOSS_CONFIG)
    tl = Learner(RLModuleSpec(**SPECS[dist]), ppo_loss, learning_rate=LR,
                 grad_clip=CLIP, seed=seed, loss_config=LOSS_CONFIG,
                 device="cpu")
    tl.load_state(rllib_state_from_jax(_np(jl._state), "cpu"))
    return jl, tl


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moments(jl):
    from ray_tpu_torch._bridge import _find_adam_state
    adam = _find_adam_state(_np(jl._state["opt_state"]))
    return int(adam.count), adam.mu, adam.nu


@pytest.mark.parametrize("dist", sorted(SPECS))
def test_five_update_trajectory_with_the_clip(dist):
    jl, tl = _pair(dist)
    batch = _batch(dist)
    jm, tm = [], []
    jl_update, tl_update = jl.update_from_batch, tl.update_from_batch
    jl.update_from_batch = lambda b: jm.append(jl_update(b)) or jm[-1]
    tl.update_from_batch = lambda b: tm.append(tl_update(b)) or tm[-1]
    JaxGroup(lambda: jl, seed=7).update_from_batch(batch, minibatch_size=16)
    LearnerGroup(lambda: tl, seed=7).update_from_batch(batch,
                                                       minibatch_size=16)
    assert len(jm) == len(tm) == 5
    for j, t in zip(jm, tm):
        assert set(j) == set(t)
        assert j["grad_norm"] > CLIP
        for k in j:
            _close(t[k], j[k])
    _trees_close(tl.get_weights(), jl.get_weights())
    count, mu, nu = _moments(jl)
    assert int(tl._state["opt_state"]["count"]) == count == 5
    _trees_close(tree_to_numpy(tl._state["opt_state"]["mu"]), mu)
    _trees_close(tree_to_numpy(tl._state["opt_state"]["nu"]), nu)


def test_resume_from_a_jax_state():
    """After 2 JAX updates the port learner takes the JAX state and the
    third update as the JAX learner does."""
    jl, tl = _pair("categorical", seed=1)
    for s in range(2):
        jl.update_from_batch(_batch("categorical", 32, seed=10 + s))
    tl.load_state(rllib_state_from_jax(_np(jl._state), "cpu"))
    assert int(tl._state["opt_state"]["count"]) == 2
    b = _batch("categorical", 32, seed=12)
    j, t = jl.update_from_batch(b), tl.update_from_batch(b)
    _close(t["total_loss"], j["total_loss"])
    _trees_close(tl.get_weights(), jl.get_weights())


def test_compute_and_apply_gradients():
    jl, tl = _pair("categorical", seed=2)
    b = _batch("categorical", 24, seed=3)
    jg, jm = jl.compute_gradients(b)
    tg, tm = tl.compute_gradients(b)
    _trees_close(tree_to_numpy(tg), _np(jg))
    assert set(tm) == set(jm) and "grad_norm" not in tm
    for k in jm:
        _close(tm[k], jm[k])
    # the group hands a learner the averaged numpy tree
    jl.apply_gradients(jax.tree.map(jnp.asarray, _np(jg)))
    tl.apply_gradients(_np(jg))
    _trees_close(tl.get_weights(), jl.get_weights())
    # set_weights keeps the moments
    w = jl.get_weights()
    tl.set_weights(w)
    _trees_close(tl.get_weights(), w)
    assert int(tl._state["opt_state"]["count"]) == 1


# ------------------------------------------------- 20 updates a loss
def _ppo_batch(rng, n):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 3, n),
            "logp": rng.normal(-1.2, 0.4, n).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": (2 * rng.normal(size=n)).astype(np.float32)}


def _vtrace_batch(rng, n, T=8):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 3, n),
            "behavior_logp": rng.normal(-1.2, 0.4, n).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32),
            "bootstrap_value": rng.normal(size=n // T).astype(np.float32)}


def _losses():
    from ray_tpu.rllib.appo import appo_loss as jax_appo_loss
    from ray_tpu.rllib.impala import impala_loss as jax_impala_loss
    from ray_tpu.rllib.pg import pg_loss as jax_pg_loss

    from ray_tpu_torch.rllib.appo import appo_loss
    from ray_tpu_torch.rllib.impala import impala_loss
    from ray_tpu_torch.rllib.pg import pg_loss
    vt = dict(rollout_len=8, gamma=0.97, rho_clip=1.0, c_clip=0.9)
    return {"ppo": (jax_ppo_loss, ppo_loss, _ppo_batch, LOSS_CONFIG),
            "pg": (jax_pg_loss, pg_loss, _ppo_batch,
                   {"vf_loss_coeff": 0.5}),
            "impala": (jax_impala_loss, impala_loss, _vtrace_batch,
                       dict(vt, entropy_coeff=0.01)),
            "appo": (jax_appo_loss, appo_loss, _vtrace_batch,
                     dict(vt, clip_param=0.3, kl_coeff=0.2))}


@pytest.mark.parametrize("name", ["appo", "impala", "pg", "ppo"])
def test_twenty_updates_match_jax(name):
    """20 updates of a learner on each on-policy loss, each on a fresh
    seeded batch, from the JAX module's weights carried by
    ``rl_params_from_jax``: every update's metrics and the final params
    against the JAX learner's. The clip acts in the first updates."""
    jax_loss, loss, make_batch, kw = _losses()[name]
    spec = SPECS["categorical"]
    jl = JaxLearner(JaxSpec(**spec), jax_loss, learning_rate=1e-3,
                    grad_clip=CLIP, seed=4, loss_config=kw)
    tl = Learner(RLModuleSpec(**spec), loss, learning_rate=1e-3,
                 grad_clip=CLIP, seed=9, loss_config=kw, device="cpu")
    tl.set_weights(rl_params_from_jax(_np(jl._state["params"]), "cpu"))
    _trees_close(tl.get_weights(), jl.get_weights(), tol=0)
    rng = np.random.default_rng(sorted(_losses()).index(name))
    clipped = 0
    for _ in range(20):
        b = make_batch(rng, 64)
        j, t = jl.update_from_batch(b), tl.update_from_batch(b)
        assert set(t) == set(j)
        for k in j:
            _close(t[k], j[k])
        clipped += j["grad_norm"] > CLIP
    assert clipped > 0
    _trees_close(tl.get_weights(), jl.get_weights())
    assert int(tl._state["opt_state"]["count"]) == 20


def test_gae_matches_jax():
    """``compute_gae`` on seeded segments with episode ends inside."""
    from ray_tpu.rllib.env_runner import compute_gae as jax_gae

    from ray_tpu_torch.rllib import compute_gae
    rng = np.random.default_rng(11)
    for T in (1, 7, 64):
        r = rng.normal(size=T).astype(np.float32)
        v = rng.normal(size=T).astype(np.float32)
        d = (rng.random(T) < 0.2).astype(np.float32)
        last = float(rng.normal())
        got, want = compute_gae(r, v, d, last, 0.99, 0.95), \
            jax_gae(r, v, d, last, 0.99, 0.95)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            _close(g, w)


def test_connectors_match_jax():
    """Each connector and a pipeline of them, with their state carried
    from the JAX package's and back, on seeded observations."""
    from ray_tpu.rllib import connectors as jc

    from ray_tpu_torch.rllib import connectors as tc

    def make(mod):
        return [mod.FlattenObs(), mod.ClipObs(-2.0, 2.0),
                mod.NormalizeObs(clip=3.0), mod.FrameStack(3),
                mod.ConnectorPipeline([mod.FlattenObs(),
                                       mod.NormalizeObs(),
                                       mod.FrameStack(2)])]

    rng = np.random.default_rng(12)
    obs = [(5 * rng.normal(size=(4, 2, 3)) + 1).astype(np.float32)
           for _ in range(6)]
    for j, t in zip(make(jc), make(tc)):
        for i, o in enumerate(obs):
            if i == 3:                   # carry the state both ways
                t.set_state(j.state())
                j.set_state(t.state())
            _close(t(o.copy()), j(o.copy()))


# ---------------------------------------------------------------- runners
ENV = dict(obs_dim=4, n_actions=3, episode_len=7)


def _runners(seed=3, worker=1):
    jspec = JaxSpec(observation_dim=4, num_actions=3, hiddens=(8,))
    w = _np(jspec.build().init(jax.random.PRNGKey(0)))
    mk = dict(num_envs=3, gamma=0.9, lambda_=0.8, seed=seed,
              worker_index=worker)
    jr = JaxRunner(lambda: JaxRandomEnv(**ENV, seed=5), jspec, **mk)
    tr = EnvRunner(lambda: RandomEnv(**ENV, seed=5),
                   RLModuleSpec(observation_dim=4, num_actions=3,
                                hiddens=(8,)), **mk)
    jr.set_weights(jax.tree.map(jnp.asarray, w))
    tr.set_weights(w)
    return jr, tr, jspec, w


def test_env_runner_on_random_env():
    jr, tr, jspec, w = _runners()
    # two segments of 5 steps: the 7-step episodes end in the second
    dones = []
    for _ in range(2):
        js, ts = jr.sample_segments(5), tr.sample_segments(5)
        for k in ("obs", "rewards", "dones"):
            np.testing.assert_array_equal(ts[k], js[k])
        dones.append(ts["dones"].any())
        _close(ts["bootstrap_value"], js["bootstrap_value"])
        out = jspec.build().forward_train(
            w, jnp.asarray(ts["obs"].reshape(-1, 4)))
        want = jax.nn.log_softmax(out["action_logits"])[
            jnp.arange(15), ts["actions"].reshape(-1)]
        _close(ts["behavior_logp"].reshape(-1), want)
    assert dones == [False, True]
    jb, tb = jr.sample(6), tr.sample(6)
    np.testing.assert_array_equal(tb["obs"], jb["obs"])
    assert tb["actions"].dtype == np.int64
    _close(tb["advantages"], jb["advantages"])
    _close(tb["value_targets"] - tb["advantages"],
           jb["value_targets"] - jb["advantages"])
    _close(tb["value_targets"], jb["value_targets"])
    assert jr.episode_returns() == tr.episode_returns() == [7.0] * 6


def test_env_runner_is_deterministic_in_its_arguments():
    """A lineage replay regenerates identical blocks: same seed and worker
    index, same actions; another worker index samples others."""
    _, a, _, w = _runners(worker=2)
    _, b, _, _ = _runners(worker=2)
    _, c, _, _ = _runners(worker=3)
    for r in (a, b, c):
        r.set_weights(w)
    sa, sb, sc = a.sample(40), b.sample(40), c.sample(40)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    assert (sa["actions"] != sc["actions"]).any()


# ------------------------------------------------------------- checkpoints
def test_checkpoints_read_in_either_package():
    jl, tl = _pair("gaussian")
    tree = {"params": tl.get_weights(), "step": np.int32(3),
            "extra": (None, [np.float32(1.5)])}
    back = JaxCheckpoint(Checkpoint.from_torch(
        {"params": tl._state["params"], "step": tree["step"],
         "extra": tree["extra"]}).path).to_jax()
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    _trees_close(back, tree, tol=0)
    jax_tree = {"params": jl._state["params"], "step": jnp.int32(3)}
    got = Checkpoint(JaxCheckpoint.from_jax(jax_tree).path).to_torch()
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(got))
    _trees_close(jax.tree.map(np.asarray, got), _np(jax_tree), tol=0)


def test_learner_state_is_on_its_device():
    _, tl = _pair("categorical")
    assert {t.device for t in tree_leaves(tl._state)} == \
        {torch.device("cpu")}
    assert all(t.requires_grad for t in tree_leaves(tl._state["params"]))
