"""DDPG and TD3: deterministic-policy-gradient continuous control, the
port of ``ray_tpu/rllib/ddpg.py``.

Reference: ``rllib/algorithms/ddpg/ddpg.py`` (+ ``ddpg_torch_model.py``:
deterministic tanh actor, Q(s, a) critic, target nets, Gaussian action
noise) and ``rllib/algorithms/td3/td3.py`` (DDPG + the three TD3 fixes:
twin critics, delayed policy updates, target policy smoothing). One
update runs in place on the learner's device: the critic step, the
policy step on every ``policy_delay``-th update only (on the others the
policy, its Adam state and its polyak target stay as they were; the
count is a host-side copy of the step count), and the critics' polyak
sync on every update. The smoothing noise is the update's one draw
(``"target"``, [B, A] standard normals), from the learner's
``torch.Generator`` unless given.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib import learner as _learner
from ray_tpu_torch.rllib.dqn import (DQN, DQNEnvRunner, OffPolicyLearner,
                                     adam, polyak_)
from ray_tpu_torch.rllib.models import init_mlp, relu_mlp_forward, tree_map
from ray_tpu_torch.rllib.rl_module import RLModuleSpec, _rollout_params
from ray_tpu_torch.rllib.sac import SACConfig, q_value


class DDPGEnvRunner(DQNEnvRunner):
    """Rollout actor: deterministic tanh policy + Gaussian exploration
    noise from the runner's numpy generator, clipped back into (-1, 1)
    (reference: ddpg's GaussianNoise exploration). The replay buffer
    stores the noisy squashed action; the env sees it rescaled to the
    Box bounds."""

    def __init__(self, env_creator, module_spec: RLModuleSpec,
                 num_envs: int = 1, seed: int = 0,
                 worker_index: int = 0, noise_sigma: float = 0.1):
        super().__init__(env_creator, module_spec, num_envs, seed,
                         worker_index)
        self._noise_sigma = noise_sigma
        low = np.asarray(module_spec.action_low, np.float32)
        high = np.asarray(module_spec.action_high, np.float32)
        self._center = (low + high) / 2.0
        self._scale = (high - low) / 2.0

    def _make_act_buf(self, shape) -> np.ndarray:
        return np.zeros(shape + (self._module.spec.action_dim,),
                        np.float32)

    @torch.no_grad()
    def _select_actions(self, epsilon: float) -> np.ndarray:
        mu = torch.tanh(relu_mlp_forward(
            _rollout_params(self._params),
            torch.as_tensor(np.asarray(self._obs, np.float32)))).numpy()
        noise = self._rng.normal(0.0, self._noise_sigma, mu.shape)
        return np.clip(mu + noise, -1.0, 1.0).astype(np.float32)

    def _env_action(self, action):
        return self._center + self._scale * action


def deterministic_policy(pi_params, obs):
    return torch.tanh(relu_mlp_forward(pi_params, obs))


class DDPGLearner(OffPolicyLearner):
    """Q(s, a) critic(s) + deterministic actor + targets, one update.
    ``twin_q``/``policy_delay``/``smooth_target_noise`` give the TD3
    variant (reference: td3.py sets exactly these on ddpg)."""

    OPTS = {"pi_opt": ("pi",), "q_opt": ("qs",)}

    def __init__(self, module_spec: RLModuleSpec, *,
                 actor_lr: float, critic_lr: float, gamma: float,
                 tau: float, grad_clip: Optional[float], seed: int,
                 twin_q: bool = False, policy_delay: int = 1,
                 smooth_target_noise: float = 0.0,
                 smooth_target_clip: float = 0.5, device=None):
        device = _learner.learner_device(device)
        self.spec = module_spec
        self._gamma = gamma
        self._tau = tau
        self._twin = twin_q
        self._delay = max(1, policy_delay)
        self._noise = smooth_target_noise
        self._noise_clip = smooth_target_clip
        adim = module_spec.action_dim
        obs_dim = module_spec.observation_dim
        h = list(module_spec.hiddens)
        gen = torch.Generator().manual_seed(seed)
        pi = init_mlp(gen, [obs_dim, *h, adim], scale=0.01)
        q_sizes = [obs_dim + adim, *h, 1]
        qs = {"q1": init_mlp(gen, q_sizes)}
        if twin_q:
            qs["q2"] = init_mlp(gen, q_sizes)
        on = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731
        self._init({"pi": on(pi), "qs": on(qs), "pi_t": on(pi),
                    "qs_t": on(qs), "steps": 0},
                   {"pi_opt": adam(actor_lr, grad_clip),
                    "q_opt": adam(critic_lr, grad_clip)}, device, seed)

    def noise_shapes(self, batch_size: int):
        if self._noise <= 0.0:
            return {}
        return {"target": ("normal", (batch_size, self.spec.action_dim))}

    def _update(self, batch, noise):
        s = self._state
        obs, next_obs = batch["obs"], batch["next_obs"]
        acts = batch["actions"]
        with torch.no_grad():
            # target action, optionally smoothed (TD3 fix #3)
            a_next = deterministic_policy(s["pi_t"], next_obs)
            if self._noise > 0.0:
                eps = torch.clamp(self._noise * noise["target"],
                                  -self._noise_clip, self._noise_clip)
                a_next = torch.clamp(a_next + eps, -1.0, 1.0)
            q_next = q_value(s["qs_t"]["q1"], next_obs, a_next)
            if self._twin:
                q_next = torch.minimum(
                    q_next, q_value(s["qs_t"]["q2"], next_obs, a_next))
            y = batch["rewards"] + self._gamma * (1.0 - batch["dones"]) \
                * q_next

        qf_loss = torch.mean((q_value(s["qs"]["q1"], obs, acts) - y) ** 2)
        if self._twin:
            qf_loss = qf_loss + torch.mean(
                (q_value(s["qs"]["q2"], obs, acts) - y) ** 2)
        self._apply("q_opt", self._grads("q_opt", qf_loss))

        # deterministic policy gradient against the updated critic
        pl = -torch.mean(q_value(s["qs"]["q1"], obs,
                                 deterministic_policy(s["pi"], obs)))
        pi_grads = self._grads("pi_opt", pl)
        s["steps"] += 1
        self._steps += 1
        with torch.no_grad():
            # delayed policy update (TD3 fix #2)
            if self._steps % self._delay == 0:
                self._apply("pi_opt", pi_grads)
                polyak_(s["pi_t"], s["pi"], self._tau)
            polyak_(s["qs_t"], s["qs"], self._tau)
            qf_loss, pl = qf_loss.detach(), pl.detach()
            return {"qf_loss": qf_loss, "policy_loss": pl,
                    "q_mean": torch.mean(q_value(s["qs"]["q1"], obs, acts)),
                    "total_loss": qf_loss + pl}


class DDPGConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DDPG)
        self.lr = 1e-3                 # actor
        self.critic_lr = 1e-3
        self.tau = 0.005
        self.exploration_noise = 0.1
        self.twin_q = False
        self.policy_delay = 1
        self.smooth_target_noise = 0.0
        self.smooth_target_clip = 0.5


class DDPG(DQN):
    config_cls = DDPGConfig
    supports_continuous = True

    def setup(self, _cfg: Dict) -> None:
        super().setup(_cfg)
        if not self.module_spec.is_continuous:
            raise ValueError(
                "DDPG/TD3 are continuous-control algorithms; use DQN or "
                "discrete SAC for Discrete action spaces")

    def _make_learner(self):
        cfg = self.config
        return DDPGLearner(
            self.module_spec, actor_lr=cfg.lr, critic_lr=cfg.critic_lr,
            gamma=cfg.gamma, tau=cfg.tau, grad_clip=cfg.grad_clip,
            seed=cfg.seed, twin_q=cfg.twin_q,
            policy_delay=cfg.policy_delay,
            smooth_target_noise=cfg.smooth_target_noise,
            smooth_target_clip=cfg.smooth_target_clip,
            device=cfg.learner_device)

    def _runner_cls(self):
        noise = self.config.exploration_noise

        class _Runner(DDPGEnvRunner):
            def __init__(self, *a, **kw):
                super().__init__(*a, noise_sigma=noise, **kw)
        _Runner.__name__ = "DDPGEnvRunner"
        return _Runner

    def compute_single_action(self, obs: np.ndarray):
        with torch.no_grad():
            mu = deterministic_policy(
                _rollout_params(self.learner.get_weights()),
                torch.as_tensor(np.asarray(obs[None], np.float32)))[0]
        low = np.asarray(self.module_spec.action_low, np.float32)
        high = np.asarray(self.module_spec.action_high, np.float32)
        return (low + high) / 2.0 + (high - low) / 2.0 * mu.numpy()


class TD3Config(DDPGConfig):
    """Reference: ``td3.py``: DDPG's defaults flipped to the TD3 paper's
    (twin critics, delay 2, smoothed targets)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or TD3)
        self.twin_q = True
        self.policy_delay = 2
        self.smooth_target_noise = 0.2
        self.smooth_target_clip = 0.5
        self.lr = 1e-3
        self.critic_lr = 1e-3


class TD3(DDPG):
    config_cls = TD3Config
