"""CQL: conservative Q-learning for offline continuous control, the port of
``ray_tpu/rllib/cql.py``.

Reference: ``rllib/algorithms/cql/cql.py`` (+
``cql/torch/cql_torch_learner.py``): SAC's twin-critic machinery plus
the conservative regularizer (logsumexp of Q over sampled actions,
uniform and the policy's, minus Q on the dataset actions) trained purely
from an offline dataset, with optional evaluation rollouts in the
environment. The update runs in place on the learner's device, the card
by default. Its draws (``noise_shapes``): SAC's ``"next"`` and ``"pi"``,
the N uniform actions in [-1, 1) (``"rand"``, [N, B, A]) and the N policy
samples' standard normals (``"cur"``, [N, B, A]).
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (_resolve_env_creator,
                                           spec_for_spaces)
from ray_tpu_torch.rllib.models import relu_mlp_forward
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.rl_module import _rollout_params
from ray_tpu_torch.rllib.sac import (ContinuousSACLearner, SACConfig,
                                     q_value, squashed_policy)
from ray_tpu_torch.tune.trainable import Trainable


class CQLLearner(ContinuousSACLearner):
    """SAC learner + the CQL(H) penalty on both critics."""

    def __init__(self, module_spec, *, cql_alpha: float = 1.0,
                 cql_n_actions: int = 4, **kw):
        self._cql_alpha = cql_alpha
        self._cql_n = cql_n_actions
        super().__init__(module_spec, **kw)

    def noise_shapes(self, batch_size: int):
        many = (self._cql_n, batch_size, self.spec.action_dim)
        return dict(super().noise_shapes(batch_size),
                    rand=("uniform", many), cur=("normal", many))

    def _penalty(self, qp, obs, acts, rand_a, pol_a, pol_logp):
        """The CQL(H) term of one critic: the samples importance-corrected
        (the uniform density is 0.5^A; the policy's samples use their
        log-prob), a logsumexp over the 2N less log 2N, less Q on the
        dataset's actions."""
        n, a_dim = self._cql_n, self.spec.action_dim
        q_rand = torch.stack([q_value(qp, obs, a) for a in rand_a])  # [N, B]
        q_pol = torch.stack([q_value(qp, obs, a) for a in pol_a])    # [N, B]
        stacked = torch.cat([q_rand - a_dim * math.log(0.5),
                             q_pol - pol_logp], dim=0)               # [2N, B]
        lse = torch.logsumexp(stacked, dim=0) - math.log(2 * n)
        return torch.mean(lse - q_value(qp, obs, acts))

    def _update(self, batch, noise):
        s = self._state
        obs, acts = batch["obs"], batch["actions"]
        alpha = torch.exp(s["log_alpha"]).detach()
        y = self._critic_target(batch, noise, alpha)
        with torch.no_grad():
            # the policy's N samples at each state, under stop-gradient
            pol = [squashed_policy(s["pi"], obs, z) for z in noise["cur"]]
            pol_a = torch.stack([a for a, _ in pol])
            pol_logp = torch.stack([lp for _, lp in pol])
        rand_a = noise["rand"]

        td1 = torch.mean((q_value(s["q1"], obs, acts) - y) ** 2)
        td2 = torch.mean((q_value(s["q2"], obs, acts) - y) ** 2)
        cql1 = self._penalty(s["q1"], obs, acts, rand_a, pol_a, pol_logp)
        cql2 = self._penalty(s["q2"], obs, acts, rand_a, pol_a, pol_logp)
        qf_total = td1 + td2 + self._cql_alpha * (cql1 + cql2)
        self._apply("q_opt", self._grads("q_opt", qf_total))
        pl, entropy, al = self._after_critics(obs, noise, alpha)
        qf_total = qf_total.detach()
        return {"qf_loss": qf_total, "td_loss": (td1 + td2).detach(),
                "cql_loss": (cql1 + cql2).detach(), "policy_loss": pl,
                "alpha_loss": al,
                "alpha": torch.exp(s["log_alpha"]).detach(),
                "entropy": entropy, "total_loss": qf_total + pl + al}


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.offline_data: Optional[Any] = None
        self.cql_alpha = 1.0
        self.cql_n_actions = 4
        self.train_batch_size = 256
        self.updates_per_step = 16
        self.evaluation_episodes = 2

    def offline(self, **kw) -> "CQLConfig":
        for k, v in kw.items():
            setattr(self, k, v)
        return self


class CQL(Trainable):
    """Offline driver: reader batches -> CQL updates on the learner's
    device (``config.learner_device``, the card unless a caller names
    another); optional env evaluation episodes a step (reference: cql
    trains from ``input_=dataset`` with evaluation rollouts)."""

    config_cls = CQLConfig

    @classmethod
    def get_default_config(cls) -> CQLConfig:
        return cls.config_cls(algo_class=cls)

    def __init__(self, config: Optional[CQLConfig] = None, **kw):
        if config is None:
            config = self.get_default_config()
        if isinstance(config, dict):
            base = self.get_default_config()
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        self._algo_config = config
        super().__init__(config.to_dict())

    def setup(self, _cfg: Dict) -> None:
        cfg = self.config = self._algo_config
        if not cfg.offline_data:
            raise ValueError("CQL requires config.offline_data "
                             "(a JSON-lines dataset path)")
        if not cfg.env:
            raise ValueError("CQL needs config.env to derive the "
                             "observation/action spaces (and for "
                             "evaluation rollouts)")
        self._env_creator = _resolve_env_creator(cfg.env, cfg.env_config)
        probe = self._env_creator()
        self.module_spec = spec_for_spaces(
            probe.observation_space, probe.action_space,
            cfg.model.get("fcnet_hiddens", (64, 64)),
            dist_for_box="squashed_gaussian")
        try:
            probe.close()
        except Exception:
            pass
        if not self.module_spec.is_continuous:
            raise ValueError("CQL is a continuous-control algorithm "
                             "(Box action spaces)")
        self.reader = JsonReader(cfg.offline_data, seed=cfg.seed)
        self.learner = self._make_learner()
        self._timesteps = 0
        low = np.asarray(self.module_spec.action_low, np.float32)
        high = np.asarray(self.module_spec.action_high, np.float32)
        self._center, self._scale = (low + high) / 2, (high - low) / 2

    def _make_learner(self) -> CQLLearner:
        cfg = self.config
        return CQLLearner(
            self.module_spec, cql_alpha=cfg.cql_alpha,
            cql_n_actions=cfg.cql_n_actions, actor_lr=cfg.lr,
            critic_lr=cfg.critic_lr, alpha_lr=cfg.alpha_lr,
            gamma=cfg.gamma, tau=cfg.tau,
            target_entropy=cfg.target_entropy, grad_clip=cfg.grad_clip,
            seed=cfg.seed, device=cfg.learner_device)

    def compute_single_action(self, obs: np.ndarray):
        with torch.no_grad():
            out = relu_mlp_forward(
                _rollout_params(self.learner.get_weights()),
                torch.as_tensor(np.asarray(obs[None], np.float32)))
        mean = torch.chunk(out, 2, dim=-1)[0][0].numpy()
        return self._center + self._scale * np.tanh(mean)

    def _eval_episodes(self, n: int) -> List[float]:
        returns = []
        env = self._env_creator()
        try:
            for i in range(n):
                out = env.reset(seed=self.config.seed * 1000 + i)
                obs = out[0] if isinstance(out, tuple) else out
                done, total = False, 0.0
                while not done:
                    step = env.step(self.compute_single_action(
                        np.asarray(obs, np.float32)))
                    if len(step) == 5:
                        obs, r, term, trunc, _ = step
                        done = term or trunc
                    else:
                        obs, r, done, _ = step
                    total += float(r)
                returns.append(total)
        finally:
            try:
                env.close()
            except Exception:
                pass
        return returns

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        metrics: Dict[str, float] = {}
        k = cfg.updates_per_step
        if k > 0:
            stacked = {key: [] for key in
                       ("obs", "next_obs", "actions", "rewards",
                        "dones")}
            for _ in range(k):
                batch = self.reader.sample(cfg.train_batch_size)
                for key in stacked:
                    stacked[key].append(batch[key].astype(np.float32))
            metrics = self.learner.update_many(
                {key: np.stack(v) for key, v in stacked.items()})
            self._timesteps += cfg.train_batch_size * k
        result = {"learner": metrics,
                  "num_env_steps_sampled_lifetime": self._timesteps}
        if cfg.evaluation_episodes:
            rets = self._eval_episodes(cfg.evaluation_episodes)
            result["episode_return_mean"] = float(np.mean(rets))
            result["episode_reward_mean"] = result["episode_return_mean"]
        return result

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "wb") as f:
            pickle.dump({"state": self.learner.state_numpy(),
                         "timesteps": self._timesteps}, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "rb") as f:
            blob = pickle.load(f)
        self.learner.load_state(blob["state"])
        self._timesteps = blob["timesteps"]

    def cleanup(self) -> None:
        pass
