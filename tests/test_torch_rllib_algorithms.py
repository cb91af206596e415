"""One tiny ``train()`` of each on-policy algorithm against the JAX
package's, and ``algo_state.pkl`` checkpoints both ways, on the CPU.

Both packages' runtimes run side by side in this process (workers on the
CPU platform). Each algorithm is built in both from the same config over
``RandomEnv`` (one runner of two envs), the port's from the JAX one's
initial weights, and trains one iteration. Sampled actions differ
between the packages (``jax.random`` against ``torch.Generator``, ROADMAP
Queue 3's standing divergence), so the policy nets part; but
``RandomEnv``'s observations, rewards and episode ends ignore the action,
the value net is a network of its own, and with ``grad_clip=0`` (no
global-norm clip to couple the two nets) its updates see only the
observations, the value targets and the groups' numpy shuffles: the
value net's weights after the iteration, the last update's ``vf_loss``,
the steps sampled and the episode returns equal the JAX run's at 1e-5 in
f32. For IMPALA and APPO the first iteration's behaviour and target
policies are one, so V-trace's targets do not depend on the actions
either. Multi-agent PPO runs on a two-agent env whose cues and rewards
come from its generator, with numpy's global generator seeded alike
before each run (its minibatch shuffle reads it).
"""

import os
import pickle
import sys

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu.rllib as jax_rllib

import ray_tpu_torch
import ray_tpu_torch.rllib as torch_rllib

os.environ.setdefault("RAY_TPU_TORCH_PLATFORM", "cpu")
cloudpickle.register_pickle_by_value(sys.modules[__name__])

TOL = 1e-5
ENV = {"obs_dim": 4, "n_actions": 2, "episode_len": 12}
TRAINING = dict(lr=1e-2, grad_clip=0.0, model={"fcnet_hiddens": (16, 16)})
ALGOS = {
    "PPO": ("PPOConfig", dict(train_batch_size=96, minibatch_size=32,
                              num_epochs=2, entropy_coeff=0.01)),
    "PG": ("PGConfig", dict(train_batch_size=64)),
    "IMPALA": ("IMPALAConfig", dict(rollout_len=16)),
    "APPO": ("APPOConfig", dict(rollout_len=16, use_kl_loss=True)),
}


def _make_cue_pair(pkg):
    """A two-agent env whose cues and rewards come from its generator and
    ignore the actions (made in a function: shipped by value)."""

    class CuePair(pkg.MultiAgentEnv):
        possible_agents = ["a0", "a1"]

        def __init__(self, _cfg=None):
            self._rng = np.random.default_rng(0)
            self._t = 0

        def _obs(self):
            return {a: self._rng.normal(size=2).astype(np.float32)
                    for a in self.possible_agents}

        def reset(self, *, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._obs(), {}

        def step(self, action_dict):
            self._t += 1
            rew = {a: float(self._rng.random()) for a in action_dict}
            done = self._t >= 6
            terms = {a: done for a in self.possible_agents}
            terms["__all__"] = done
            return self._obs(), rew, terms, {"__all__": False}, {}

    return CuePair


def _config(pkg, name):
    if name == "MultiAgentPPO":
        cfg = (pkg.MultiAgentPPOConfig()
               .environment(_make_cue_pair(pkg))
               .env_runners(num_env_runners=1)
               .training(train_batch_size=48, minibatch_size=16,
                         num_epochs=2, **TRAINING)
               .debugging(seed=2))
        return cfg.multi_agent(
            policies={"shared": {"observation_dim": 2, "num_actions": 2}},
            policy_mapping_fn=lambda aid: "shared")
    cls, kw = ALGOS[name]
    env = pkg.RandomEnv
    return (getattr(pkg, cls)()
            .environment(lambda c: env(**c), env_config=dict(ENV))
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2)
            .training(**TRAINING, **kw)
            .debugging(seed=1))


def _weights(algo):
    if hasattr(algo, "learners"):
        return {pid: l.get_weights() for pid, l in algo.learners.items()}
    return algo.get_policy_weights()


def _set_weights(algo, w):
    if hasattr(algo, "learners"):
        for pid, l in algo.learners.items():
            l.set_weights(w[pid])
    else:
        algo.learner_group.set_weights(w)
    algo._sync_weights()


def _train(algo):
    np.random.seed(11)
    return algo.train()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each algorithm's one iteration in both packages, and the PPO
    checkpoints restored across them."""
    ray_tpu.init(num_cpus=4, _num_initial_workers=0)
    ray_tpu_torch.init(num_cpus=4, _num_initial_workers=0)
    out = {}
    try:
        for name in [*ALGOS, "MultiAgentPPO"]:
            ja = _config(jax_rllib, name).build()
            ta = _config(torch_rllib, name).learners(device="cpu").build()
            try:
                _set_weights(ta, _weights(ja))
                out[name] = {"jax": _train(ja), "port": _train(ta),
                             "jax_w": _weights(ja), "port_w": _weights(ta)}
                if name == "PPO":       # each restores the other's
                    out["ckpt"] = d = tmp_path_factory.mktemp("ckpt")
                    for src, algo in (("jax", ja), ("port", ta)):
                        (d / src).mkdir()
                        algo.save_checkpoint(str(d / src))
                    for src, algo in (("jax", ta), ("port", ja)):
                        algo.load_checkpoint(str(d / src))
                        out[f"restored_{src}"] = (
                            algo.get_policy_weights(), algo._timesteps,
                            algo.compute_single_action(
                                np.zeros(4, np.float32)))
            finally:
                ja.cleanup()
                ta.cleanup()
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _vf_close(got, want):
    assert len(got["vf"]) == len(want["vf"])
    for g, w in zip(got["vf"], want["vf"]):
        _close(g["w"], w["w"])
        _close(g["b"], w["b"])


@pytest.mark.parametrize("name", [*ALGOS, "MultiAgentPPO"])
def test_one_iteration_matches_jax_in_the_value_net(runs, name):
    r = runs[name]
    jr, tr = r["jax"], r["port"]
    assert tr["num_env_steps_sampled_lifetime"] == \
        jr["num_env_steps_sampled_lifetime"] > 0
    assert tr["training_iteration"] == jr["training_iteration"] == 1
    _close(tr["episode_return_mean"], jr["episode_return_mean"])
    if name == "MultiAgentPPO":
        assert set(tr["learner"]) == set(jr["learner"]) == {"shared"}
        jm, tm = jr["learner"]["shared"], tr["learner"]["shared"]
        _vf_close(r["port_w"]["shared"], r["jax_w"]["shared"])
    else:
        jm, tm = jr["learner"], tr["learner"]
        _vf_close(r["port_w"], r["jax_w"])
    assert set(tm) == set(jm)
    assert all(np.isfinite(v) for v in tm.values())
    _close(tm["vf_loss"], jm["vf_loss"])
    # the policy nets part where the sampled actions did
    pw = r["port_w"]["shared"] if name == "MultiAgentPPO" else r["port_w"]
    jw = r["jax_w"]["shared"] if name == "MultiAgentPPO" else r["jax_w"]
    assert any(not np.allclose(p["w"], j["w"], atol=TOL)
               for p, j in zip(pw["pi"], jw["pi"]))


@pytest.mark.parametrize("src", ["jax", "port"])
def test_algo_state_restores_across_the_packages(runs, src):
    """``algo_state.pkl`` of numpy trees: each package's PPO restores the
    other's weights and step count exactly."""
    ckpt = runs["ckpt"]
    with open(os.path.join(ckpt, src, "algo_state.pkl"), "rb") as f:
        state = pickle.load(f)
    weights, timesteps, action = runs[f"restored_{src}"]
    assert timesteps == state["timesteps"] == 96
    want = runs["PPO"][f"{src}_w"]
    for part in ("pi", "vf"):
        for g, w, s in zip(weights[part], want[part],
                           state["weights"][part]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(g[k], w[k])
                np.testing.assert_array_equal(s[k], w[k])
    assert action in (0, 1)
