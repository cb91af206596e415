"""EnvRunner: CPU actors stepping (vectorized) gymnasium envs, the port of
``ray_tpu/rllib/env_runner.py``.

Reference: ``rllib/evaluation/rollout_worker.py:159`` (``sample`` :653)
/ the new ``env/env_runner.py`` API. Runners hold the env and a CPU copy
of the policy params; ``sample()`` returns a flat rollout batch with GAE
advantages already computed, so the learner's update consumes it
directly. The policy runs on ``torch.device("cpu")``: env runners are CPU
actors by design (as the JAX package's are), whatever device the learner
holds; actions are sampled from a ``torch.Generator`` seeded from
``(seed, worker_index)``, so a runner is deterministic in its arguments.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.models import tree_to_tensors
from ray_tpu_torch.rllib.rl_module import ROLLOUT_DEVICE, RLModuleSpec


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                dones: np.ndarray, last_value: float,
                gamma: float, lam: float):
    """Generalized advantage estimation over one rollout segment."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last_gae = 0.0
    for t in reversed(range(T)):
        next_value = last_value if t == T - 1 else values[t + 1]
        non_terminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * non_terminal - values[t]
        last_gae = delta + gamma * lam * non_terminal * last_gae
        adv[t] = last_gae
    returns = adv + values
    return adv, returns


def one_thread_in_a_worker() -> None:
    """In a runtime worker (an env-runner actor or a rollout task, one
    CPU each), one torch thread: a runner's policy is a few small matmuls
    a step, and runners sharing a host must not oversubscribe it (as the
    port's stage and rank actors)."""
    from ray_tpu_torch.core.global_state import try_global_worker
    if getattr(try_global_worker(), "kind", None) == "worker":
        torch.set_num_threads(1)


def rollout_generator(seed: int, worker_index: int) -> torch.Generator:
    """A runner's sampling generator, seeded as the JAX runner's key is
    (``PRNGKey(seed * 10_003 + worker_index)``)."""
    return torch.Generator().manual_seed(seed * 10_003 + worker_index)


class EnvRunner:
    """One rollout actor (spawn several for parallel sampling). Its
    policy runs on ``torch.device("cpu")``."""

    def __init__(self, env_creator: Callable[[], Any],
                 module_spec: RLModuleSpec, num_envs: int = 1,
                 gamma: float = 0.99, lambda_: float = 0.95,
                 seed: int = 0, worker_index: int = 0,
                 obs_connectors: Optional[list] = None):
        from ray_tpu_torch.rllib.connectors import ConnectorPipeline
        one_thread_in_a_worker()
        self._envs = [env_creator() for _ in range(num_envs)]
        self._module = module_spec.build()
        self._connectors = ConnectorPipeline(obs_connectors) \
            if obs_connectors else None
        self._params = None
        self._gamma = gamma
        self._lambda = lambda_
        self._gen = rollout_generator(seed, worker_index)
        self._obs = np.stack([
            self._reset(e, seed * 7919 + worker_index * 131 + i)
            for i, e in enumerate(self._envs)])
        self._cur_obs: Optional[np.ndarray] = None
        self._ep_returns = [0.0] * num_envs
        self._completed: list = []

    @staticmethod
    def _reset(env, seed=None):
        out = env.reset(seed=seed)
        return out[0] if isinstance(out, tuple) else out

    def set_weights(self, params) -> None:
        """Keep a CPU f32 copy of ``params`` (numpy arrays or tensors)."""
        self._params = tree_to_tensors(params, ROLLOUT_DEVICE)

    def get_weights(self):
        return self._params

    def _transformed_obs(self) -> np.ndarray:
        """Connector-transformed view of the CURRENT raw obs, applied
        exactly once per distinct observation (stateful connectors —
        FrameStack, NormalizeObs — must see each obs once)."""
        if self._cur_obs is None:
            self._cur_obs = self._connectors(self._obs) \
                if self._connectors else self._obs.astype(np.float32)
        return self._cur_obs

    def _rollout(self, num_steps: int):
        """Shared stepping loop for both sampling modes. Returns
        time-major buffers [T, B, ...] plus the bootstrap values of the
        final state."""
        assert self._params is not None, "set_weights first"
        n_envs = len(self._envs)
        spec = self._module.spec
        continuous = spec.is_continuous
        cur0 = self._transformed_obs()
        obs_buf = np.zeros((num_steps, n_envs) + cur0.shape[1:],
                           np.float32)
        if continuous:
            act_buf = np.zeros((num_steps, n_envs, spec.action_dim),
                               np.float32)
            low = np.asarray(spec.action_low, np.float32)
            high = np.asarray(spec.action_high, np.float32)
        else:
            act_buf = np.zeros((num_steps, n_envs), np.int64)
        logp_buf = np.zeros((num_steps, n_envs), np.float32)
        val_buf = np.zeros((num_steps, n_envs), np.float32)
        rew_buf = np.zeros((num_steps, n_envs), np.float32)
        done_buf = np.zeros((num_steps, n_envs), np.float32)

        for t in range(num_steps):
            cur = self._transformed_obs()
            actions, logps, values = self._module.forward_exploration(
                self._params, cur, self._gen)
            obs_buf[t] = cur
            act_buf[t] = actions
            logp_buf[t] = logps
            val_buf[t] = values
            for i, env in enumerate(self._envs):
                # the stored action is the RAW sample (ratios in the
                # loss need the sampled point); the env sees it clipped
                # to the Box bounds
                out = env.step(np.clip(actions[i], low, high)
                               if continuous else int(actions[i]))
                if len(out) == 5:
                    obs, rew, terminated, truncated, _ = out
                    done = terminated or truncated
                else:  # old gym API
                    obs, rew, done, _ = out
                rew_buf[t, i] = rew
                done_buf[t, i] = float(done)
                self._ep_returns[i] += float(rew)
                if done:
                    self._completed.append(self._ep_returns[i])
                    self._ep_returns[i] = 0.0
                    obs = self._reset(env)
                self._obs[i] = obs
            self._cur_obs = None  # raw obs changed

        # bootstrap values of the final state (the transform is cached,
        # so the next rollout's t=0 reuses it — still one application)
        _, _, last_values = self._module.forward_exploration(
            self._params, self._transformed_obs(), self._gen)
        return (obs_buf, act_buf, logp_buf, val_buf, rew_buf, done_buf,
                np.asarray(last_values, np.float32))

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps per env; returns the flattened batch with
        GAE advantages."""
        (obs_buf, act_buf, logp_buf, val_buf, rew_buf, done_buf,
         last_values) = self._rollout(num_steps)
        n_envs = len(self._envs)
        adv = np.zeros_like(rew_buf)
        ret = np.zeros_like(rew_buf)
        for i in range(n_envs):
            adv[:, i], ret[:, i] = compute_gae(
                rew_buf[:, i], val_buf[:, i], done_buf[:, i],
                float(last_values[i]), self._gamma, self._lambda)

        flat = lambda arr: arr.reshape(  # noqa: E731
            (num_steps * n_envs,) + arr.shape[2:])
        return {
            "obs": flat(obs_buf),
            "actions": flat(act_buf),
            "logp": flat(logp_buf),
            "value_targets": flat(ret),
            "advantages": flat(adv),
        }

    def sample_blocks(self, num_blocks: int, steps_per_block: int
                      ) -> "Any":
        """Generator of ``num_blocks`` consecutive rollout blocks of
        ``steps_per_block`` env steps each — the producer half of the
        rollout-to-train streaming dataflow. Works as a streaming actor
        call on a live runner; ``rllib.rollout_stream`` wraps the same
        loop in a deterministic generator TASK when lineage replay of the
        stream prefix is required."""
        for _ in range(num_blocks):
            yield self.sample(steps_per_block)

    def sample_segments(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Time-major rollout segments for off-policy correction
        (IMPALA/V-trace needs the [T, B] structure, the behaviour
        log-probs and the bootstrap value of the final state; GAE is not
        computed — the learner's V-trace recursion replaces it)."""
        (obs_buf, act_buf, logp_buf, _val, rew_buf, done_buf,
         last_values) = self._rollout(num_steps)
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "behavior_logp": logp_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "bootstrap_value": last_values,
        }

    def episode_returns(self, clear: bool = True) -> list:
        out = list(self._completed)
        if clear:
            self._completed = []
        return out

    def ping(self) -> bool:
        return True
