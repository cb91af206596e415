"""Algorithm: the RL training driver, a Tune Trainable, the port of
``ray_tpu/rllib/algorithm.py``.

Reference: ``rllib/algorithms/algorithm.py:202`` (``step`` :810,
``training_step`` :1633): sample in parallel from env-runner actors,
update via the LearnerGroup, sync weights back, report
episode-return metrics. Checkpointing via the Trainable protocol: a
checkpoint is ``algo_state.pkl``, the learner's weights as a numpy tree
and the step count, the JAX package's file, so either package restores
the other's.

The env runners (``{"num_cpus": 1}`` actors, or generator tasks when
``streaming_rollouts``) run their policy on the CPU. A local learner
(``num_learners=0``) runs on ``config.learner_device``, the card unless
a caller names another. Remote learners are the JAX package's
``{"num_cpus": 1}`` actors, each building its learner with no device
named: in its worker that is the card where the worker sees one, the CPU
in a runtime on the CPU platform (``RAY_TPU_TORCH_PLATFORM=cpu``), and
otherwise the learner raises for want of a card.
"""

from __future__ import annotations

import pickle
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rl_module import RLModuleSpec
from ray_tpu_torch.tune.trainable import Trainable


def _resolve_env_creator(env, env_config) -> Callable[[], Any]:
    if callable(env) and not isinstance(env, str):
        return lambda: env(env_config)
    if isinstance(env, str):
        def make():
            import gymnasium as gym
            return gym.make(env, **env_config)
        return make
    raise ValueError(f"Cannot resolve env: {env!r}")


def spec_for_spaces(obs_space, act_space, hiddens,
                    dist_for_box: str = "gaussian") -> RLModuleSpec:
    """Build the module spec from gymnasium spaces: Discrete ->
    categorical head, Box -> diagonal-Gaussian head (reference: the
    model catalog's action-distribution selection,
    ``rllib/models/catalog.py`` get_action_dist)."""
    obs_dim = int(np.prod(obs_space.shape))
    if hasattr(act_space, "n"):  # Discrete
        return RLModuleSpec(observation_dim=obs_dim,
                            num_actions=int(act_space.n),
                            hiddens=tuple(hiddens))
    if hasattr(act_space, "low"):  # Box
        return RLModuleSpec(
            observation_dim=obs_dim,
            action_dim=int(np.prod(act_space.shape)),
            dist=dist_for_box,
            action_low=tuple(np.asarray(act_space.low,
                                        np.float32).ravel()),
            action_high=tuple(np.asarray(act_space.high,
                                         np.float32).ravel()),
            hiddens=tuple(hiddens))
    raise ValueError(f"Unsupported action space: {act_space!r}")


class Algorithm(Trainable):
    """Subclasses define ``loss_fn`` + ``loss_config`` via config."""

    config_cls = AlgorithmConfig
    #: whether this algorithm's loss handles Box-space (Gaussian)
    #: policies — PPO and SAC do; discrete-only losses fail fast at
    #: build time instead of a KeyError inside the first jitted update
    supports_continuous = False

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return cls.config_cls(algo_class=cls)

    def __init__(self, config: Optional[AlgorithmConfig] = None, **kw):
        if config is None:
            config = self.get_default_config()
        if isinstance(config, dict):
            base = self.get_default_config()
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        self._algo_config = config
        super().__init__(config.to_dict())

    # -- Trainable protocol -------------------------------------------
    def setup(self, _cfg: Dict) -> None:
        # Trainable.__init__ rebound self.config to the plain dict;
        # expose the AlgorithmConfig object (reference behavior).
        cfg = self.config = self._algo_config
        env_creator = self._env_creator = _resolve_env_creator(
            cfg.env, cfg.env_config)
        probe = env_creator()
        self.module_spec = spec_for_spaces(
            probe.observation_space, probe.action_space,
            cfg.model.get("fcnet_hiddens", (64, 64)))
        if self.module_spec.is_continuous and not self.supports_continuous:
            raise ValueError(
                f"{type(self).__name__} supports Discrete action spaces "
                f"only; use PPO or SAC for Box spaces")
        try:
            probe.close()
        except Exception:
            pass

        spec = self.module_spec
        loss_fn = self.loss_fn()
        loss_config = self.loss_config()
        lr, clip, seed = cfg.lr, cfg.grad_clip, cfg.seed

        # remote learners name no device (see the module's docstring)
        device = cfg.learner_device if cfg.num_learners == 0 else None

        def make_learner() -> Learner:
            return Learner(spec, loss_fn, learning_rate=lr,
                           grad_clip=clip, seed=seed,
                           loss_config=loss_config, device=device)

        self.learner_group = LearnerGroup(
            make_learner, num_learners=cfg.num_learners, seed=cfg.seed)
        self._inference_module = spec.build()
        self._cached_weights = None

        n_runners = max(1, cfg.num_env_runners)
        if getattr(cfg, "streaming_rollouts", False):
            # Rollout producers are per-step generator TASKS
            # (rollout_stream.py) — deterministic, lineage-replayable.
            # No long-lived runner actors to keep in sync.
            self.env_runners = []
        else:
            runner_cls = ray_tpu_torch.remote(num_cpus=1)(EnvRunner)
            self.env_runners = [
                runner_cls.remote(env_creator, spec,
                                  cfg.num_envs_per_env_runner,
                                  cfg.gamma,
                                  getattr(cfg, "lambda_", 0.95),
                                  cfg.seed, i)
                for i in range(n_runners)]
        self._sync_weights()
        self._timesteps = 0
        self._iterations = 0
        self._return_window: List[float] = []

    # Subclass hooks ---------------------------------------------------
    def loss_fn(self) -> Callable:
        raise NotImplementedError

    def loss_config(self) -> Dict[str, Any]:
        return {}

    # ------------------------------------------------------------------
    def _sync_weights(self) -> None:
        self._cached_weights = self.learner_group.get_weights()
        w_ref = ray_tpu_torch.put(self._cached_weights)
        ray_tpu_torch.get([r.set_weights.remote(w_ref)
                     for r in self.env_runners])

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        if getattr(cfg, "streaming_rollouts", False):
            return self._step_streaming()
        per_runner = max(1, cfg.train_batch_size
                         // (len(self.env_runners)
                             * cfg.num_envs_per_env_runner))
        batches = ray_tpu_torch.get(
            [r.sample.remote(per_runner) for r in self.env_runners])
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in batches[0]}
        self._timesteps += len(batch["obs"])

        metrics = self.learner_group.update_from_batch(
            batch, minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs)
        self._sync_weights()

        returns: List[float] = []
        for r in ray_tpu_torch.get(
                [r.episode_returns.remote() for r in self.env_runners]):
            returns.extend(r)
        self._return_window.extend(returns)
        self._return_window = self._return_window[-100:]
        mean_return = (float(np.mean(self._return_window))
                       if self._return_window else float("nan"))
        return {
            "episode_return_mean": mean_return,
            # legacy alias used by older tuned examples
            "episode_reward_mean": mean_return,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "learner": metrics,
        }

    def _step_streaming(self) -> Dict[str, Any]:
        """Streaming rollout→train step: N generator-task runners
        stream GAE'd rollout blocks straight into the learner's
        ``iter_batches`` (first epoch trains as blocks arrive; later
        epochs shuffle the collected batch). The consumer-idle
        fraction is reported as ``rollout_train_bubble``."""
        from ray_tpu_torch.rllib.rollout_stream import (
            RolloutBlockStream, make_rollout_streams)
        cfg = self.config
        self._iterations += 1
        n_runners = max(1, cfg.num_env_runners)
        per_runner = max(1, cfg.train_batch_size
                         // (n_runners * cfg.num_envs_per_env_runner))
        block_steps = min(max(1, cfg.rollout_block_steps), per_runner)
        n_blocks = max(1, -(-per_runner // block_steps))
        weights_ref = ray_tpu_torch.put(self.learner_group.get_weights())
        gens = make_rollout_streams(
            self._env_creator, self.module_spec, weights_ref,
            n_runners, n_blocks, block_steps,
            num_envs=cfg.num_envs_per_env_runner, gamma=cfg.gamma,
            lambda_=getattr(cfg, "lambda_", 0.95),
            # fresh trajectories every iteration, deterministic within
            # one (lineage replay must regenerate identical blocks)
            seed=cfg.seed + 100_000 * self._iterations)
        stream = RolloutBlockStream(gens, collect=True)
        try:
            metrics = self.learner_group.update_from_stream(
                stream, minibatch_size=cfg.minibatch_size,
                num_epochs=cfg.num_epochs)
        finally:
            stream.close()
        sstats = stream.stats()
        self._timesteps += int(sstats["rows"])
        self._cached_weights = None
        self._return_window.extend(stream.episode_returns())
        self._return_window = self._return_window[-100:]
        mean_return = (float(np.mean(self._return_window))
                       if self._return_window else float("nan"))
        return {
            "episode_return_mean": mean_return,
            "episode_reward_mean": mean_return,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "learner": metrics,
            "rollout_train_bubble": sstats["bubble"],
            "rollout_stream": sstats,
        }

    def train(self) -> Dict[str, Any]:
        result = super().train()
        result.setdefault("timesteps_total", self._timesteps)
        return result

    # -- checkpointing -------------------------------------------------
    def save_checkpoint(self, checkpoint_dir: str) -> str:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "wb") as f:
            pickle.dump({"weights": self.learner_group.get_weights(),
                         "timesteps": self._timesteps}, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_weights(state["weights"])
        self._timesteps = state["timesteps"]
        self._sync_weights()

    def get_policy_weights(self):
        return self.learner_group.get_weights()

    def compute_single_action(self, obs: np.ndarray):
        if self._cached_weights is None:
            self._cached_weights = self.learner_group.get_weights()
        action = self._inference_module.forward_inference(
            self._cached_weights, np.asarray([obs]))
        if self.module_spec.is_continuous:
            return np.asarray(action[0])
        return int(action[0])

    def cleanup(self) -> None:
        for r in self.env_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.learner_group.shutdown()

    stop = Trainable.stop
