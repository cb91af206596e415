"""Multi-agent RL: shared environments, per-policy learners, the port of
``ray_tpu/rllib/multi_agent.py``.

Reference: ``rllib/env/multi_agent_env.py`` (dict-keyed obs/action
protocol with ``__all__`` termination), ``rllib/policy/policy_map.py``
+ ``policy_mapping_fn`` (agent -> policy routing), and the new stack's
``MultiRLModule`` (``core/rl_module/marl_module.py``). One Learner per
policy, each on ``config.learner_device`` (the card by default); the
runners route per-agent transitions to per-policy GAE segments on the
host and run every policy on the CPU.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm, _resolve_env_creator
from ray_tpu_torch.rllib.env_runner import (compute_gae,
                                            one_thread_in_a_worker,
                                            rollout_generator)
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.models import tree_to_tensors
from ray_tpu_torch.rllib.ppo import PPOConfig, ppo_loss
from ray_tpu_torch.rllib.rl_module import ROLLOUT_DEVICE, RLModuleSpec


class MultiAgentEnv:
    """Dict-keyed environment protocol (reference:
    ``multi_agent_env.py``): ``reset() -> (obs_dict, info)``;
    ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
    infos)`` where each is keyed by agent id and ``terminateds`` carries
    the special ``"__all__"`` flag."""

    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self) -> None:
        pass


class MultiAgentEnvRunner:
    """Rollout actor for MultiAgentEnv: routes each agent's transitions
    to its policy's batch and computes per-agent GAE at segment end. Its
    policies run on ``torch.device("cpu")``, sampling from a generator
    seeded as ``EnvRunner``'s."""

    def __init__(self, env_creator, specs: Dict[str, RLModuleSpec],
                 policy_mapping_fn, gamma: float = 0.99,
                 lambda_: float = 0.95, seed: int = 0,
                 worker_index: int = 0):
        one_thread_in_a_worker()
        self._env = env_creator()
        self._modules = {pid: spec.build() for pid, spec in specs.items()}
        self._params: Dict[str, Any] = {}
        self._map = policy_mapping_fn
        self._gamma, self._lambda = gamma, lambda_
        self._gen = rollout_generator(seed, worker_index)
        out = self._env.reset(seed=seed * 7919 + worker_index)
        self._obs = out[0] if isinstance(out, tuple) else out
        self._ep_return = 0.0
        self._completed: List[float] = []

    def set_weights(self, params_by_policy: Dict[str, Any]) -> None:
        self._params = {pid: tree_to_tensors(w, ROLLOUT_DEVICE)
                        for pid, w in params_by_policy.items()}

    def sample(self, num_steps: int) -> Dict[str, Dict[str, np.ndarray]]:
        """Returns {policy_id: flat_batch} with GAE computed per agent."""
        traj = defaultdict(lambda: defaultdict(list))  # agent -> field
        for _ in range(num_steps):
            actions, logps, values = {}, {}, {}
            for aid, ob in self._obs.items():
                pid = self._map(aid)
                a, lp, v = self._modules[pid].forward_exploration(
                    self._params[pid], np.asarray([ob], np.float32),
                    self._gen)
                actions[aid] = int(a[0])
                logps[aid] = float(lp[0])
                values[aid] = float(v[0])
            obs2, rews, terms, truncs, _ = self._env.step(actions)
            for aid in actions:
                t = traj[aid]
                t["obs"].append(np.asarray(self._obs[aid], np.float32))
                t["actions"].append(actions[aid])
                t["logp"].append(logps[aid])
                t["values"].append(values[aid])
                t["rewards"].append(float(rews.get(aid, 0.0)))
                done = bool(terms.get(aid) or truncs.get(aid)
                            or terms.get("__all__"))
                t["dones"].append(float(done))
                self._ep_return += float(rews.get(aid, 0.0))
            if terms.get("__all__") or truncs.get("__all__"):
                self._completed.append(self._ep_return)
                self._ep_return = 0.0
                out = self._env.reset()
                self._obs = out[0] if isinstance(out, tuple) else out
            else:
                self._obs = obs2

        by_policy: Dict[str, Dict[str, List]] = defaultdict(
            lambda: defaultdict(list))
        for aid, t in traj.items():
            pid = self._map(aid)
            rewards = np.asarray(t["rewards"], np.float32)
            values = np.asarray(t["values"], np.float32)
            dones = np.asarray(t["dones"], np.float32)
            # bootstrap with the policy's value of the agent's last obs
            if aid in self._obs and self._params.get(pid) is not None:
                _, _, bv = self._modules[pid].forward_exploration(
                    self._params[pid],
                    np.asarray([self._obs[aid]], np.float32), self._gen)
                last_value = float(bv[0]) * (1.0 - dones[-1])
            else:
                last_value = 0.0
            adv, ret = compute_gae(rewards, values, dones, last_value,
                                   self._gamma, self._lambda)
            p = by_policy[pid]
            p["obs"].extend(t["obs"])
            p["actions"].extend(t["actions"])
            p["logp"].extend(t["logp"])
            p["advantages"].extend(adv.tolist())
            p["value_targets"].extend(ret.tolist())
        return {
            pid: {"obs": np.stack(b["obs"]),
                  "actions": np.asarray(b["actions"], np.int64),
                  "logp": np.asarray(b["logp"], np.float32),
                  "advantages": np.asarray(b["advantages"], np.float32),
                  "value_targets": np.asarray(b["value_targets"],
                                              np.float32)}
            for pid, b in by_policy.items()}

    def episode_returns(self, clear: bool = True) -> list:
        out = list(self._completed)
        if clear:
            self._completed = []
        return out


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MultiAgentPPO)
        #: policy_id -> dict(observation_dim=..., num_actions=...) or {}
        #: ({} = probe the env's per-agent spaces)
        self.policies: Dict[str, dict] = {}
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: aid

    def multi_agent(self, *, policies=None, policy_mapping_fn=None,
                    **_ignored) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = ({p: {} for p in policies}
                             if not isinstance(policies, dict)
                             else policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self


class MultiAgentPPO(Algorithm):
    """PPO over per-policy learners (reference: multi-agent PPO via
    PolicyMap; here each policy owns an independent Learner)."""

    config_cls = MultiAgentPPOConfig

    def setup(self, _cfg: Dict) -> None:
        cfg = self.config = self._algo_config
        if not cfg.policies:
            raise ValueError("MultiAgentPPO needs config.policies")
        env_creator = _resolve_env_creator(cfg.env, cfg.env_config)
        probe = env_creator()
        out = probe.reset()
        obs0 = out[0] if isinstance(out, tuple) else out
        mapping = cfg.policy_mapping_fn

        specs: Dict[str, RLModuleSpec] = {}
        for pid, p_spec in cfg.policies.items():
            if p_spec.get("observation_dim"):
                obs_dim = p_spec["observation_dim"]
                n_act = p_spec["num_actions"]
            else:
                # probe: first agent mapped to this policy
                aid = next(a for a in obs0 if mapping(a) == pid)
                obs_dim = int(np.prod(np.shape(obs0[aid])))
                n_act = int(probe.action_spaces[aid].n) \
                    if hasattr(probe, "action_spaces") \
                    else int(p_spec.get("num_actions", 2))
            specs[pid] = RLModuleSpec(
                observation_dim=obs_dim, num_actions=n_act,
                hiddens=tuple(cfg.model.get("fcnet_hiddens", (64, 64))))
        probe.close()
        self._specs = specs

        loss_config = self.loss_config()
        self.learners = {
            pid: Learner(spec, ppo_loss, learning_rate=cfg.lr,
                         grad_clip=cfg.grad_clip, seed=cfg.seed + i,
                         loss_config=loss_config,
                         device=cfg.learner_device)
            for i, (pid, spec) in enumerate(specs.items())}

        n_runners = max(1, cfg.num_env_runners)
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(MultiAgentEnvRunner)
        self.env_runners = [
            runner_cls.remote(env_creator, specs, mapping, cfg.gamma,
                              cfg.lambda_, cfg.seed, i)
            for i in range(n_runners)]
        self._sync_weights()
        self._timesteps = 0
        self._return_window: List[float] = []

    def loss_config(self) -> Dict[str, Any]:
        c = self.config
        return {"clip_param": c.clip_param,
                "vf_loss_coeff": c.vf_loss_coeff,
                "entropy_coeff": c.entropy_coeff,
                "vf_clip_param": c.vf_clip_param}

    def _sync_weights(self) -> None:
        weights = {pid: l.get_weights()
                   for pid, l in self.learners.items()}
        ref = ray_tpu_torch.put(weights)
        ray_tpu_torch.get([r.set_weights.remote(ref)
                     for r in self.env_runners])

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        per_runner = max(1, cfg.train_batch_size // len(self.env_runners))
        samples = ray_tpu_torch.get(
            [r.sample.remote(per_runner) for r in self.env_runners])
        metrics: Dict[str, Any] = {}
        for pid, learner in self.learners.items():
            parts = [s[pid] for s in samples if pid in s]
            if not parts:
                continue
            batch = {k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]}
            self._timesteps += len(batch["obs"])
            mb = cfg.minibatch_size or len(batch["obs"])
            for _ in range(cfg.num_epochs):
                perm = np.random.permutation(len(batch["obs"]))
                for s in range(0, len(perm), mb):
                    idx = perm[s:s + mb]
                    metrics[pid] = learner.update_from_batch(
                        {k: v[idx] for k, v in batch.items()})
        self._sync_weights()

        returns: List[float] = []
        for r in ray_tpu_torch.get(
                [r.episode_returns.remote() for r in self.env_runners]):
            returns.extend(r)
        self._return_window.extend(returns)
        self._return_window = self._return_window[-100:]
        mean_return = (float(np.mean(self._return_window))
                       if self._return_window else float("nan"))
        return {"episode_return_mean": mean_return,
                "episode_reward_mean": mean_return,
                "num_env_steps_sampled_lifetime": self._timesteps,
                "learner": metrics}

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        import os
        import pickle
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "wb") as f:
            pickle.dump({
                "weights": {pid: l.get_weights()
                            for pid, l in self.learners.items()},
                "timesteps": self._timesteps}, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        for pid, w in state["weights"].items():
            self.learners[pid].set_weights(w)
        self._timesteps = state["timesteps"]
        self._sync_weights()

    def cleanup(self) -> None:
        for r in self.env_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
