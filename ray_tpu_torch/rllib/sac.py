"""SAC: soft actor-critic with twin Q networks and a learned temperature,
continuous (tanh-squashed Gaussian) and discrete (categorical), the port
of ``ray_tpu/rllib/sac.py``.

Reference: ``rllib/algorithms/sac/sac.py`` + the torch loss in
``sac/torch/sac_torch_learner.py`` (twin critics, polyak target sync,
entropy temperature tuned toward a target entropy) and the Box-space
Gaussian policy model in ``sac/sac_torch_model.py:15``. The continuous
path is the canonical SAC: reparameterized tanh-squashed samples,
Q(s, a) critics over concatenated state-action, target entropy
``-action_dim``. The discrete formulation follows Christodoulou 2019
(expectations over the action distribution instead of reparameterized
samples). Either way one update runs, in place on the learner's device:
both critic losses under one optimizer (so the global-norm clip spans
both nets), the policy loss against the just-updated critics, the
temperature's loss with its own unclipped Adam, and the polyak sync
toward the updated critics. The continuous update's two standard-normal
draws come from the learner's ``torch.Generator`` unless given
(``noise``), as in :class:`ray_tpu_torch.rllib.dqn.OffPolicyLearner`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import learner as _learner
from ray_tpu_torch.rllib.dqn import (DQN, DQNConfig, DQNEnvRunner,
                                     OffPolicyLearner, adam, polyak_)
from ray_tpu_torch.rllib.models import (LOG_STD_MAX, LOG_STD_MIN, init_mlp,
                                        mlp_forward, relu_mlp_forward,
                                        squashed_gaussian_sample, tree_map)
from ray_tpu_torch.rllib.rl_module import RLModuleSpec, _rollout_params


class SACEnvRunner(DQNEnvRunner):
    """Exploration = sampling from the categorical policy (reference:
    SAC explores with its stochastic policy; epsilon is ignored). The
    draw is the JAX runner's: the softmax's cumulative sum against the
    runner's numpy generator."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        module = self._module
        rng = self._rng
        na = module.spec.num_actions

        @torch.no_grad()
        def sample_policy(params, obs):
            logits = mlp_forward(_rollout_params(params)["pi"],
                                 torch.as_tensor(np.asarray(obs,
                                                            np.float32)))
            p = torch.softmax(logits, dim=-1).numpy().astype(np.float64)
            cum = np.cumsum(p, axis=-1)
            r = rng.random((p.shape[0], 1))
            # clamp: a float cumsum can end below 1.0, and (r < cum)
            # all-False would silently argmax to action 0
            return np.minimum((r < cum).argmax(axis=-1)
                              + ((r >= cum[:, -1:]).ravel()
                                 * (na - 1)).astype(np.int64),
                              na - 1)

        module.forward_inference = sample_policy

    def sample(self, num_steps: int, epsilon: float = 0.0):
        return super().sample(num_steps, epsilon=0.0)


class SACLearner(OffPolicyLearner):
    """Twin soft Q + categorical policy + learned log-alpha, one update
    with polyak target sync."""

    OPTS = {"pi_opt": ("pi",), "q_opt": ("q1", "q2"),
            "a_opt": ("log_alpha",)}

    def __init__(self, module_spec: RLModuleSpec, *,
                 actor_lr: float, critic_lr: float, alpha_lr: float,
                 gamma: float, tau: float,
                 target_entropy: Optional[float],
                 grad_clip: Optional[float], seed: int, device=None):
        device = _learner.learner_device(device)
        self.module = module_spec.build()
        self._gamma = gamma
        self._tau = tau
        na = module_spec.num_actions
        # reference target_entropy="auto" for Discrete: 0.98 * log|A|
        self._target_entropy = target_entropy if target_entropy \
            is not None else 0.98 * math.log(na)
        gen = torch.Generator().manual_seed(seed)
        sizes = [module_spec.observation_dim, *module_spec.hiddens, na]
        pi = self.module.init(gen)
        q1, q2 = init_mlp(gen, sizes), init_mlp(gen, sizes)
        on = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
        self._init({"pi": on(pi), "q1": on(q1), "q2": on(q2),
                    "q1_t": on(q1), "q2_t": on(q2),
                    "log_alpha": torch.zeros((), device=device)},
                   {"pi_opt": adam(actor_lr, grad_clip),
                    "q_opt": adam(critic_lr, grad_clip),
                    "a_opt": adam(alpha_lr, None)}, device, seed)

    @staticmethod
    def _policy_dist(pi_params, obs):
        logp = torch.log_softmax(mlp_forward(pi_params["pi"], obs), dim=-1)
        return torch.exp(logp), logp

    def _update(self, batch, noise):
        s = self._state
        obs, next_obs = batch["obs"], batch["next_obs"]
        rows = torch.arange(obs.shape[0], device=self.device)
        acts = batch["actions"]
        with torch.no_grad():
            alpha = torch.exp(s["log_alpha"])
            # soft target: y = r + gamma * E_a'[minQt - alpha * logpi]
            p_next, logp_next = self._policy_dist(s["pi"], next_obs)
            q1t = mlp_forward(s["q1_t"], next_obs)
            q2t = mlp_forward(s["q2_t"], next_obs)
            v_next = torch.sum(
                p_next * (torch.minimum(q1t, q2t) - alpha * logp_next), -1)
            y = batch["rewards"] + self._gamma * (1.0 - batch["dones"]) \
                * v_next

        l1 = torch.mean((mlp_forward(s["q1"], obs)[rows, acts] - y) ** 2)
        l2 = torch.mean((mlp_forward(s["q2"], obs)[rows, acts] - y) ** 2)
        qf_loss = l1 + l2
        self._apply("q_opt", self._grads("q_opt", qf_loss))

        # policy: E_a[alpha * logpi - minQ] against the updated critics
        p, logp = self._policy_dist(s["pi"], obs)
        with torch.no_grad():
            minq = torch.minimum(mlp_forward(s["q1"], obs),
                                 mlp_forward(s["q2"], obs))
        pl = torch.mean(torch.sum(p * (alpha * logp - minq), -1))
        entropy = -torch.mean(torch.sum(p * logp, -1))
        self._apply("pi_opt", self._grads("pi_opt", pl))

        # temperature toward the target entropy
        al = torch.exp(s["log_alpha"]) \
            * (entropy.detach() - self._target_entropy)
        self._apply("a_opt", self._grads("a_opt", al))

        with torch.no_grad():
            polyak_(s["q1_t"], s["q1"], self._tau)
            polyak_(s["q2_t"], s["q2"], self._tau)
            return {"qf_loss": qf_loss.detach(), "q1_loss": l1.detach(),
                    "q2_loss": l2.detach(), "policy_loss": pl.detach(),
                    "alpha_loss": al.detach(),
                    "alpha": torch.exp(s["log_alpha"]),
                    "entropy": entropy.detach(),
                    "total_loss": (qf_loss + pl + al).detach()}


class ContinuousSACEnvRunner(DQNEnvRunner):
    """Rollout actor for Box spaces: actions are reparameterized
    tanh-squashed Gaussian samples (standard normals from a
    ``torch.Generator`` seeded as the JAX runner's key); the replay
    buffer stores the squashed action in (-1, 1) (what the critics see),
    the env gets it rescaled to the space bounds. The stepping loop is
    DQNEnvRunner's: only action selection and the env action differ."""

    def __init__(self, env_creator, module_spec: RLModuleSpec,
                 num_envs: int = 1, seed: int = 0,
                 worker_index: int = 0):
        super().__init__(env_creator, module_spec, num_envs, seed,
                         worker_index)
        self._gen = torch.Generator().manual_seed(
            seed * 10_003 + worker_index + 1)
        low = np.asarray(module_spec.action_low, np.float32)
        high = np.asarray(module_spec.action_high, np.float32)
        self._center = (low + high) / 2.0
        self._scale = (high - low) / 2.0

    def _make_act_buf(self, shape) -> np.ndarray:
        return np.zeros(shape + (self._module.spec.action_dim,),
                        np.float32)

    @torch.no_grad()
    def _select_actions(self, epsilon: float) -> np.ndarray:
        out = relu_mlp_forward(_rollout_params(self._params),
                               torch.as_tensor(np.asarray(self._obs,
                                                          np.float32)))
        mean, log_std = torch.chunk(out, 2, dim=-1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        u = mean + torch.exp(log_std) * torch.randn(
            mean.shape, generator=self._gen)
        return torch.tanh(u).numpy().astype(np.float32)

    def _env_action(self, action):
        return self._center + self._scale * action


def squashed_policy(pi_params, obs, noise):
    """The tanh-squashed Gaussian policy's reparameterized sample at
    ``noise`` and its log-prob."""
    out = relu_mlp_forward(pi_params, obs)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    return squashed_gaussian_sample(None, mean, log_std, noise=noise)


def q_value(q_params, obs, act):
    """A Q(s, a) critic over the concatenated state and action -> [B]."""
    return relu_mlp_forward(q_params, torch.cat([obs, act], -1))[..., 0]


class ContinuousSACLearner(OffPolicyLearner):
    """Canonical SAC (Haarnoja 2018, as in the reference's torch
    learner): twin Q(s, a), tanh-squashed reparameterized policy,
    learned temperature toward target entropy -|A|. Its draws
    (``noise_shapes``): ``"next"`` for the target's next action, ``"pi"``
    for the policy loss's action, both [B, A] standard normals."""

    OPTS = {"pi_opt": ("pi",), "q_opt": ("q1", "q2"),
            "a_opt": ("log_alpha",)}

    def __init__(self, module_spec: RLModuleSpec, *,
                 actor_lr: float, critic_lr: float, alpha_lr: float,
                 gamma: float, tau: float,
                 target_entropy: Optional[float],
                 grad_clip: Optional[float], seed: int, device=None):
        device = _learner.learner_device(device)
        self.spec = module_spec
        self._gamma = gamma
        self._tau = tau
        adim = module_spec.action_dim
        self._target_entropy = (target_entropy if target_entropy
                                is not None else -float(adim))
        gen = torch.Generator().manual_seed(seed)
        obs_dim = module_spec.observation_dim
        h = list(module_spec.hiddens)
        pi = init_mlp(gen, [obs_dim, *h, 2 * adim], scale=0.01)
        q_sizes = [obs_dim + adim, *h, 1]
        q1, q2 = init_mlp(gen, q_sizes), init_mlp(gen, q_sizes)
        on = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
        self._init({"pi": on(pi), "q1": on(q1), "q2": on(q2),
                    "q1_t": on(q1), "q2_t": on(q2),
                    "log_alpha": torch.zeros((), device=device)},
                   {"pi_opt": adam(actor_lr, grad_clip),
                    "q_opt": adam(critic_lr, grad_clip),
                    "a_opt": adam(alpha_lr, None)}, device, seed)

    def noise_shapes(self, batch_size: int):
        shape = (batch_size, self.spec.action_dim)
        return {"next": ("normal", shape), "pi": ("normal", shape)}

    def _critic_target(self, batch, noise, alpha):
        """y = r + gamma * (minQt(s', a') - alpha * logpi(a'|s'))."""
        s = self._state
        next_obs = batch["next_obs"]
        with torch.no_grad():
            a_next, logp_next = squashed_policy(s["pi"], next_obs,
                                                noise["next"])
            q_next = torch.minimum(q_value(s["q1_t"], next_obs, a_next),
                                   q_value(s["q2_t"], next_obs, a_next))
            return batch["rewards"] + self._gamma \
                * (1.0 - batch["dones"]) * (q_next - alpha * logp_next)

    def _after_critics(self, obs, noise, alpha):
        """The policy step against the just-updated critics, the
        temperature's, then the polyak sync toward the updated critics;
        returns (policy loss, entropy, alpha loss)."""
        s = self._state
        a, logp = squashed_policy(s["pi"], obs, noise["pi"])
        minq = torch.minimum(q_value(s["q1"], obs, a),
                             q_value(s["q2"], obs, a))
        pl = torch.mean(alpha * logp - minq)
        entropy = -torch.mean(logp)
        self._apply("pi_opt", self._grads("pi_opt", pl))
        al = -torch.exp(s["log_alpha"]) \
            * (self._target_entropy - entropy.detach())
        self._apply("a_opt", self._grads("a_opt", al))
        with torch.no_grad():
            polyak_(s["q1_t"], s["q1"], self._tau)
            polyak_(s["q2_t"], s["q2"], self._tau)
        return pl.detach(), entropy.detach(), al.detach()

    def _update(self, batch, noise):
        s = self._state
        obs, acts = batch["obs"], batch["actions"]
        alpha = torch.exp(s["log_alpha"]).detach()
        y = self._critic_target(batch, noise, alpha)
        l1 = torch.mean((q_value(s["q1"], obs, acts) - y) ** 2)
        l2 = torch.mean((q_value(s["q2"], obs, acts) - y) ** 2)
        qf_loss = l1 + l2
        self._apply("q_opt", self._grads("q_opt", qf_loss))
        pl, entropy, al = self._after_critics(obs, noise, alpha)
        qf_loss = qf_loss.detach()
        return {"qf_loss": qf_loss, "q1_loss": l1.detach(),
                "q2_loss": l2.detach(), "policy_loss": pl,
                "alpha_loss": al, "alpha": torch.exp(s["log_alpha"]).detach(),
                "entropy": entropy, "total_loss": qf_loss + pl + al}


class SACConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.lr = 3e-4                  # actor lr
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.tau = 0.01
        self.target_entropy: Optional[float] = None   # auto
        self.train_batch_size = 64
        self.num_steps_sampled_before_learning_starts = 500
        self.updates_per_step = 4


class SAC(DQN):
    config_cls = SACConfig
    supports_continuous = True

    def _make_learner(self):
        cfg = self.config
        cls = ContinuousSACLearner if self.module_spec.is_continuous \
            else SACLearner
        return cls(
            self.module_spec, actor_lr=cfg.lr, critic_lr=cfg.critic_lr,
            alpha_lr=cfg.alpha_lr, gamma=cfg.gamma, tau=cfg.tau,
            target_entropy=cfg.target_entropy, grad_clip=cfg.grad_clip,
            seed=cfg.seed, device=cfg.learner_device)

    def _runner_cls(self):
        if self.module_spec.is_continuous:
            return ContinuousSACEnvRunner
        return SACEnvRunner

    def compute_single_action(self, obs: np.ndarray):
        if not self.module_spec.is_continuous:
            return super().compute_single_action(obs)
        with torch.no_grad():
            out = relu_mlp_forward(
                _rollout_params(self.learner.get_weights()),
                torch.as_tensor(np.asarray(obs[None], np.float32)))
        mean = torch.chunk(out, 2, dim=-1)[0][0].numpy()
        low = np.asarray(self.module_spec.action_low, np.float32)
        high = np.asarray(self.module_spec.action_high, np.float32)
        center, scale = (low + high) / 2.0, (high - low) / 2.0
        return center + scale * np.tanh(mean)
