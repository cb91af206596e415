"""rllib's networks, distributions and on-policy losses against the JAX
package's, on the CPU in f32 at 1e-5.

The same numpy inputs from a seed go through ``ray_tpu.rllib`` and
``ray_tpu_torch.rllib``; parameter trees are drawn by the JAX module and
carried over as they are (both packages keep the ``{"w": [in, out],
"b"}`` layout under ``"pi"`` and ``"vf"``). Held: the MLP and both heads
(with ``log_std`` pushed past its clip), the Gaussian log-density,
entropy and tanh correction, the squashed sample at the same noise,
V-trace off policy (the rho and c clips active, episode ends inside the
segment), and the PPO (categorical and Gaussian), PG, IMPALA and APPO
losses: value, metrics and the gradient of every leaf, with PPO's ratio
and value clips active.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib.appo import appo_loss as jax_appo_loss
from ray_tpu.rllib.impala import impala_loss as jax_impala_loss
from ray_tpu.rllib.impala import vtrace_returns as jax_vtrace
from ray_tpu.rllib.pg import pg_loss as jax_pg_loss
from ray_tpu.rllib.ppo import ppo_loss as jax_ppo_loss
from ray_tpu.rllib.rl_module import RLModuleSpec as JaxSpec

from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.appo import appo_loss
from ray_tpu_torch.rllib.impala import impala_loss, vtrace_returns
from ray_tpu_torch.rllib.models import tree_leaves, tree_paths
from ray_tpu_torch.rllib.pg import pg_loss
from ray_tpu_torch.rllib.ppo import ppo_loss
from ray_tpu_torch.rllib.rl_module import RLModuleSpec

TOL = 1e-5
OBS, ACTS, HID = 5, 3, (16, 12)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _jax_params(dist="categorical", seed=0):
    spec = dict(observation_dim=OBS, hiddens=HID)
    spec.update(num_actions=ACTS) if dist == "categorical" else \
        spec.update(dist="gaussian", action_dim=2)
    params = JaxSpec(**spec).build().init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params), spec


def _torch(tree, grad=False):
    out = models.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)
    if grad:
        for t in tree_leaves(out):
            t.requires_grad_(True)
    return out


def test_init_draws_the_jax_tree_s_structure_and_shapes():
    """The seeds draw other numbers (jax.random and torch.Generator), but
    the tree, its shapes and the He scales are the JAX package's."""
    for dist in ("categorical", "gaussian"):
        jp, spec = _jax_params(dist)
        tp = RLModuleSpec(**spec).build().init(0)
        assert jax.tree.structure(jp) == jax.tree.structure(
            models.tree_to_numpy(tp))
        for a, b in zip(jax.tree.leaves(jp),
                        jax.tree.leaves(models.tree_to_numpy(tp))):
            assert a.shape == b.shape and b.dtype == np.float32
        assert float(tp["vf"][0]["w"].std()) == pytest.approx(
            np.sqrt(2 / OBS), rel=0.3)
        assert float(tp["pi"][-1]["w"].abs().max()) < 0.1   # scale 0.01
        assert all(float(layer["b"].abs().max()) == 0
                   for layer in tp["pi"] + tp["vf"])


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_mlp_forward(act):
    jp, _ = _jax_params()
    x = np.random.default_rng(1).normal(size=(7, OBS)).astype(np.float32)
    if act == "tanh":
        want = jmodels.mlp_forward(jp["pi"], jnp.asarray(x))
        got = models.mlp_forward(_torch(jp["pi"]), torch.tensor(x))
    else:
        want = jmodels.relu_mlp_forward(jp["vf"], jnp.asarray(x))
        got = models.relu_mlp_forward(_torch(jp["vf"]), torch.tensor(x))
    _close(got, want)


def test_actor_critic_heads():
    jp, _ = _jax_params()
    x = np.random.default_rng(2).normal(size=(9, OBS)).astype(np.float32)
    jl, jv = jmodels.actor_critic_forward(jp, jnp.asarray(x))
    tl, tv = models.actor_critic_forward(_torch(jp), torch.tensor(x))
    _close(tl, jl)
    _close(tv, jv)
    assert tuple(tv.shape) == (9,)


def test_gaussian_head_clips_log_std():
    jp, _ = _jax_params("gaussian")
    # a large last pi layer drives log_std past both ends of its clip
    jp["pi"][-1]["w"] = jp["pi"][-1]["w"] * 4000.0
    x = np.random.default_rng(3).normal(size=(11, OBS)).astype(np.float32)
    want = jmodels.gaussian_actor_critic_forward(jp, jnp.asarray(x))
    got = models.gaussian_actor_critic_forward(_torch(jp), torch.tensor(x))
    for g, w in zip(got, want):
        _close(g, w, tol=1e-4 * max(1.0, float(np.abs(w).max())))
    ls = np.asarray(want[1])
    assert (ls == models.LOG_STD_MAX).any()
    assert (ls == models.LOG_STD_MIN).any()


def test_gaussian_distributions():
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(6, 3)).astype(np.float32)
    log_std = rng.uniform(-2, 1, size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    args = (mean, log_std, x)
    _close(models.diag_gaussian_logp(*map(torch.tensor, args)),
           jmodels.diag_gaussian_logp(*map(jnp.asarray, args)))
    _close(models.diag_gaussian_entropy(torch.tensor(log_std)),
           jmodels.diag_gaussian_entropy(jnp.asarray(log_std)))
    u = (3 * rng.normal(size=(6, 3))).astype(np.float32)
    _close(models.tanh_logp_correction(torch.tensor(u)),
           jmodels.tanh_logp_correction(jnp.asarray(u)), tol=1e-4)


def test_squashed_sample_at_the_same_noise():
    """JAX draws the noise from its key; the port takes that noise."""
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(4, 2)).astype(np.float32)
    log_std = rng.uniform(-1, 0.5, size=(4, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    a_j, lp_j = jmodels.squashed_gaussian_sample(
        key, jnp.asarray(mean), jnp.asarray(log_std))
    noise = np.asarray(jax.random.normal(key, mean.shape, jnp.float32))
    a_t, lp_t = models.squashed_gaussian_sample(
        None, torch.tensor(mean), torch.tensor(log_std),
        noise=torch.tensor(noise))
    _close(a_t, a_j)
    _close(lp_t, lp_j, tol=1e-4)


def test_vtrace_off_policy_with_clips_and_episode_ends():
    T, B = 9, 4
    rng = np.random.default_rng(6)
    args = [rng.normal(-1, 0.5, (T, B)), rng.normal(-1, 0.5, (T, B)),
            rng.normal(size=(T, B)), rng.normal(size=(T, B)),
            rng.normal(size=(B,)), (rng.random((T, B)) < 0.2)]
    args = [a.astype(np.float32) for a in args]
    kw = dict(gamma=0.95, rho_clip=1.0, c_clip=0.9)
    vs_j, adv_j = jax_vtrace(*map(jnp.asarray, args), **kw)
    vs_t, adv_t = vtrace_returns(*map(torch.tensor, args), **kw)
    ratio = np.exp(args[0] - args[1])
    assert (ratio > 1.0).any() and (ratio < 0.9).any()
    assert args[5].any()
    _close(vs_t, vs_j)
    _close(adv_t, adv_j)
    assert not vs_t.requires_grad


# ---------------------------------------------------------------- losses
def _ppo_batch(rng, n, continuous):
    actions = rng.normal(size=(n, 2)).astype(np.float32) if continuous \
        else rng.integers(0, ACTS, n)
    return {
        "obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "actions": actions,
        # behaviour log-probabilities spread so the ratio clip takes hold
        "logp": (rng.normal(-1.5, 0.6, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        # targets far from the values so the value clip takes hold
        "value_targets": (4 * rng.normal(size=n)).astype(np.float32),
    }


def _vtrace_batch(rng, T, B):
    n = T * B
    return {
        "obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, n),
        "behavior_logp": rng.normal(-1.2, 0.4, n).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": (rng.random(n) < 0.1).astype(np.float32),
        "bootstrap_value": rng.normal(size=B).astype(np.float32),
    }


LOSSES = {
    "ppo_categorical": (jax_ppo_loss, ppo_loss, "ppo", dict(
        clip_param=0.2, vf_loss_coeff=0.5, entropy_coeff=0.01,
        vf_clip_param=1.5)),
    "ppo_gaussian": (jax_ppo_loss, ppo_loss, "ppo_box", dict(
        clip_param=0.2, vf_loss_coeff=0.5, entropy_coeff=0.01,
        vf_clip_param=1.5)),
    "pg": (jax_pg_loss, pg_loss, "ppo", dict(vf_loss_coeff=0.7)),
    "impala": (jax_impala_loss, impala_loss, "vtrace", dict(
        rollout_len=6, gamma=0.97, vf_loss_coeff=0.5, entropy_coeff=0.02,
        rho_clip=1.0, c_clip=0.8)),
    "appo": (jax_appo_loss, appo_loss, "vtrace", dict(
        rollout_len=6, gamma=0.97, clip_param=0.3, vf_loss_coeff=0.5,
        entropy_coeff=0.02, kl_coeff=0.2, rho_clip=1.0, c_clip=0.8)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_metrics_and_gradients(name):
    jax_loss, torch_loss, kind, kw = LOSSES[name]
    rng = np.random.default_rng(sorted(LOSSES).index(name))
    jp, spec = _jax_params("gaussian" if kind == "ppo_box"
                           else "categorical", seed=3)
    batch = _vtrace_batch(rng, 6, 5) if kind == "vtrace" \
        else _ppo_batch(rng, 40, kind == "ppo_box")
    jmod, tmod = JaxSpec(**spec).build(), RLModuleSpec(**spec).build()

    def jax_total(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return jax_loss(jmod.forward_train(p, jb["obs"]), jb, **kw)

    (jv, jm), jg = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    tp = _torch(jp, grad=True)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tv, tm = torch_loss(tmod.forward_train(tp, tb["obs"]), tb, **kw)
    grads = torch.autograd.grad(tv, tree_leaves(tp))
    _close(tv.detach(), jv)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k].detach(), jm[k])
    jgn = jax.tree.map(np.asarray, jg)
    for path, g in zip(tree_paths(tp), grads):
        want = jgn
        for p in path:
            want = want[p]
        _close(g, want)
    if kind != "vtrace" and name != "pg":
        _assert_ppo_clips_active(tmod, tp, tb, kw)


def _assert_ppo_clips_active(module, params, batch, kw):
    """Some ratios leave [1 - clip, 1 + clip] and some squared value
    errors pass vf_clip_param ** 2: both clips shape the gradient."""
    with torch.no_grad():
        out = module.forward_train(params, batch["obs"])
        if "action_mean" in out:
            logp = models.diag_gaussian_logp(
                out["action_mean"], out["action_log_std"], batch["actions"])
        else:
            logp = torch.log_softmax(out["action_logits"], -1).gather(
                -1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        err = (out["vf_preds"] - batch["value_targets"]) ** 2
    clip = kw["clip_param"]
    assert ((ratio < 1 - clip) | (ratio > 1 + clip)).any()
    assert ((ratio > 1 - clip) & (ratio < 1 + clip)).any()
    assert (err > kw["vf_clip_param"] ** 2).any()
    assert (err < kw["vf_clip_param"] ** 2).any()
