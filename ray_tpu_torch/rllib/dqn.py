"""DQN: off-policy Q-learning with replay + target network, the port of
``ray_tpu/rllib/dqn.py``.

Reference: ``rllib/algorithms/dqn/dqn.py`` (replay-buffer training loop,
target-network sync every ``target_network_update_freq``) and the torch
loss in ``dqn/torch/dqn_torch_learner.py`` (Huber TD error, optional
double-Q). The update (Q forward, double-Q target, Huber loss, optax's
``clip_by_global_norm -> adam`` as ``ClipAdamW``, and the periodic hard
target sync) runs in place on the learner's device, the card by default;
the sync follows a host-side copy of the step count, so it costs no host
round trip. ``update_many`` is the counterpart of the JAX package's
``lax.scan`` burst (``_scanned_update``): K updates back to back on the
device, one sync with the host at the end.

The replay buffer and the env runners are numpy and CPU (the runners are
CPU actors by design, as in the JAX package); the buffer is the JAX
package's, so a seed samples the same rows in either package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.models.training import ClipAdamW, global_norm
from ray_tpu_torch.rllib import learner as _learner
from ray_tpu_torch.rllib.algorithm import Algorithm, _resolve_env_creator
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env_runner import one_thread_in_a_worker
from ray_tpu_torch.rllib.models import (mlp_forward, tree_get, tree_leaves,
                                        tree_map, tree_paths, tree_to_numpy,
                                        tree_to_tensors)
from ray_tpu_torch.rllib.rl_module import RLModuleSpec


class ReplayBuffer:
    """Uniform ring buffer (reference:
    ``rllib/utils/replay_buffers/replay_buffer.py``)."""

    def __init__(self, capacity: int, obs_shape, seed: int = 0,
                 action_shape=(), action_dtype=np.int64):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self.obs = np.zeros((capacity,) + tuple(obs_shape), np.float32)
        self.next_obs = np.zeros_like(self.obs)
        self.actions = np.zeros((capacity,) + tuple(action_shape),
                                action_dtype)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self._idx = 0
        self._size = 0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(batch["obs"])
        idx = (self._idx + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.dones[idx] = batch["dones"]
        self._idx = int((self._idx + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=n)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx]}

    def sample_many(self, k: int, n: int) -> Dict[str, np.ndarray]:
        """K independent minibatches stacked [K, n, ...]: the feed of a
        learner's ``update_many`` burst."""
        idx = self._rng.integers(0, self._size, size=(k, n))
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx],
                "rewards": self.rewards[idx], "dones": self.dones[idx]}

    def __len__(self) -> int:
        return self._size


class DQNEnvRunner:
    """Collects (s, a, r, s', done) transitions with epsilon-greedy
    exploration over the Q-network (reference: DQN's EnvRunner +
    EpsilonGreedy exploration). The Q-network runs on the CPU."""

    def __init__(self, env_creator: Callable[[], Any],
                 module_spec: RLModuleSpec, num_envs: int = 1,
                 seed: int = 0, worker_index: int = 0):
        one_thread_in_a_worker()
        self._envs = [env_creator() for _ in range(num_envs)]
        self._module = module_spec.build()
        self._params = None
        self._rng = np.random.default_rng(seed * 9973 + worker_index)
        self._obs = np.stack([self._reset(e, seed + i)
                              for i, e in enumerate(self._envs)])
        self._ep_returns = [0.0] * num_envs
        self._completed: List[float] = []

    @staticmethod
    def _reset(env, seed=None):
        out = env.reset(seed=seed)
        return out[0] if isinstance(out, tuple) else out

    def set_weights(self, params) -> None:
        self._params = params

    def ping(self) -> bool:
        return True

    # --- hooks the SAC and DDPG runners override ----------------------
    def _make_act_buf(self, shape) -> np.ndarray:
        return np.zeros(shape, np.int64)

    def _select_actions(self, epsilon: float) -> np.ndarray:
        greedy = self._module.forward_inference(self._params, self._obs)
        n_envs = len(self._envs)
        explore = self._rng.random(n_envs) < epsilon
        random_a = self._rng.integers(
            0, self._module.spec.num_actions, size=n_envs)
        return np.where(explore, random_a, greedy)

    def _env_action(self, action):
        return int(action)

    def sample(self, num_steps: int, epsilon: float
               ) -> Dict[str, np.ndarray]:
        if self._params is None:
            raise RuntimeError("set_weights first")
        n_envs = len(self._envs)
        shape = (num_steps, n_envs)
        obs_buf = np.zeros(shape + self._obs.shape[1:], np.float32)
        next_buf = np.zeros_like(obs_buf)
        act_buf = self._make_act_buf(shape)
        rew_buf = np.zeros(shape, np.float32)
        done_buf = np.zeros(shape, np.float32)
        for t in range(num_steps):
            actions = self._select_actions(epsilon)
            obs_buf[t] = self._obs
            act_buf[t] = actions
            for i, env in enumerate(self._envs):
                out = env.step(self._env_action(actions[i]))
                if len(out) == 5:
                    obs, rew, terminated, truncated, _ = out
                    done = terminated or truncated
                else:
                    obs, rew, done, _ = out
                    terminated = done
                rew_buf[t, i] = rew
                # bootstrap mask: only termination zeroes the next
                # state's value; a time-limit truncation is not terminal
                done_buf[t, i] = float(terminated)
                next_buf[t, i] = obs
                self._ep_returns[i] += float(rew)
                if done:
                    self._completed.append(self._ep_returns[i])
                    self._ep_returns[i] = 0.0
                    obs = self._reset(env)
                self._obs[i] = obs

        flat = lambda a: a.reshape((num_steps * n_envs,) + a.shape[2:])  # noqa: E731
        return {"obs": flat(obs_buf), "next_obs": flat(next_buf),
                "actions": flat(act_buf), "rewards": flat(rew_buf),
                "dones": flat(done_buf)}

    def episode_returns(self, clear: bool = True) -> list:
        out = list(self._completed)
        if clear:
            self._completed = []
        return out


# ------------------------------------------------------------- learners
def adam(learning_rate: float, grad_clip: Optional[float]) -> ClipAdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))``, or
    ``adam(lr)`` alone for a falsy ``grad_clip``."""
    return ClipAdamW(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.0, clip_norm=grad_clip or None)


def draw_noise(generator: torch.Generator,
               shapes: Dict[str, Tuple[str, tuple]], device
               ) -> Dict[str, torch.Tensor]:
    """The draws of one update: ``{name: ("normal" | "uniform", shape)}``
    -> standard normals, or uniforms in [-1, 1), f32 on ``device``, from
    ``generator`` in the order the names are given."""
    out = {}
    for name, (kind, shape) in shapes.items():
        if kind == "normal":
            out[name] = torch.randn(shape, generator=generator,
                                    dtype=torch.float32, device=device)
        else:
            out[name] = torch.rand(shape, generator=generator,
                                   dtype=torch.float32,
                                   device=device) * 2.0 - 1.0
    return out


def polyak_(target, online, tau: float) -> None:
    """``target = (1 - tau) * target + tau * online``, leaf by leaf, in
    place."""
    paths = tree_paths(target)
    t = [tree_get(target, p) for p in paths]
    o = [tree_get(online, p) for p in paths]
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, torch._foreach_mul(o, tau))


class OffPolicyLearner:
    """The state and update protocol of the off-policy learners (DQN,
    SAC, DDPG/TD3, CQL).

    ``_state`` keeps the JAX learner's keys: networks as trees of f32
    tensors on ``device``, each optimizer's ``{"count", "mu", "nu"}``
    (``OPTS`` names the state keys it steps), ``"steps"`` where the
    algorithm counts updates. ``_update(batch, noise)`` is one update in
    place, its metrics left on the device; the updates that sample take
    their draws as ``noise`` (``noise_shapes``), drawn from the learner's
    ``torch.Generator`` when none are given, so a test can feed the JAX
    package's own draws."""

    #: optimizer state key -> the state keys of the networks it steps
    OPTS: Dict[str, Tuple[str, ...]] = {}
    #: the network the env runners act with
    POLICY = "pi"

    def _init(self, state: Dict[str, Any], opts: Dict[str, ClipAdamW],
              device, seed: int) -> None:
        """Take the fresh networks of ``state`` and the optimizer of each
        ``OPTS`` key; zero moments."""
        self.device = device
        self._opts = opts
        self._gen = torch.Generator(device=device).manual_seed(seed)
        for name, keys in self.OPTS.items():
            params = self._opt_tree(state, keys)
            state[name] = {"count": torch.zeros((), dtype=torch.int32,
                                                device=device),
                           "mu": tree_map(torch.zeros_like, params),
                           "nu": tree_map(torch.zeros_like, params)}
        self.load_state(state)

    @staticmethod
    def _opt_tree(state, keys):
        return state[keys[0]] if len(keys) == 1 else \
            {k: state[k] for k in keys}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Take a state in this learner's layout, leaves as tensors or
        numpy arrays (``ray_tpu_torch._bridge.offpolicy_state_from_jax``
        carries a JAX learner's state into it); the leaves are copied to
        the device."""
        out = {}
        for k, v in state.items():
            if k == "steps":
                out[k] = torch.tensor(int(v), dtype=torch.int32,
                                      device=self.device)
            elif k in self.OPTS:
                out[k] = {"count": torch.tensor(int(v["count"]),
                                                dtype=torch.int32,
                                                device=self.device),
                          "mu": tree_to_tensors(v["mu"], self.device),
                          "nu": tree_to_tensors(v["nu"], self.device)}
            else:
                out[k] = tree_to_tensors(v, self.device)
        self._state = out
        self._steps = int(out["steps"]) if "steps" in out else 0
        self._leaves, self._paths = {}, {}
        for name, keys in self.OPTS.items():
            tree = self._opt_tree(out, keys)
            paths = tree_paths(tree)
            leaves = [tree_get(tree, p) for p in paths]
            for leaf in leaves:
                leaf.requires_grad_(True)
            self._paths[name], self._leaves[name] = paths, leaves

    def state_numpy(self) -> Dict[str, Any]:
        """The state with numpy leaves and int counts (a checkpoint's)."""
        out = {}
        for k, v in self._state.items():
            if k == "steps":
                out[k] = int(v)
            elif k in self.OPTS:
                out[k] = {"count": int(v["count"]),
                          "mu": tree_to_numpy(v["mu"]),
                          "nu": tree_to_numpy(v["nu"])}
            else:
                out[k] = tree_to_numpy(v)
        return out

    def _grads(self, name: str, loss: torch.Tensor) -> List[torch.Tensor]:
        """The gradients of ``loss`` for optimizer ``name``'s leaves
        (zeros for a leaf the loss does not reach, as JAX's)."""
        return list(torch.autograd.grad(loss, self._leaves[name],
                                        allow_unused=True,
                                        materialize_grads=True))

    @torch.no_grad()
    def _apply(self, name: str, grads: List[torch.Tensor]) -> torch.Tensor:
        """One clip + Adam step of optimizer ``name``; returns the
        gradients' global norm before the clip."""
        gnorm = global_norm(grads)
        self._opts[name].update(
            grads, self._state[name], self._leaves[name], gnorm,
            paths=self._paths[name])
        return gnorm

    def noise_shapes(self, batch_size: int) -> Dict[str, Tuple[str, tuple]]:
        return {}

    def _draws(self, batch, noise) -> Dict[str, torch.Tensor]:
        if noise is not None:
            return {k: (v if isinstance(v, torch.Tensor) else
                        torch.tensor(np.asarray(v, np.float32))).to(
                            self.device, torch.float32)
                    for k, v in noise.items()}
        return draw_noise(self._gen, self.noise_shapes(
            batch["obs"].shape[0]), self.device)

    def _update(self, batch: Dict[str, torch.Tensor],
                noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    # -- public --------------------------------------------------------
    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        b = _learner._batch_tensors(batch, self.device)
        metrics = self._update(b, self._draws(b, noise))
        return _learner.Learner._floats(metrics)

    def update_many(self, batches: Dict[str, np.ndarray],
                    noise: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, float]:
        """K updates from minibatches stacked ``[K, B, ...]`` (and draws
        stacked ``[K, ...]``, else drawn update by update), back to back
        on the device; returns the last update's metrics, as the JAX
        package's scanned burst does."""
        stack = _learner._batch_tensors(batches, self.device)
        k = next(iter(stack.values())).shape[0]
        metrics = {}
        for i in range(k):
            b = {name: v[i] for name, v in stack.items()}
            n = None if noise is None else \
                {name: np.asarray(v)[i] for name, v in noise.items()}
            metrics = self._update(b, self._draws(b, n))
        return _learner.Learner._floats(metrics)

    def get_weights(self):
        """The policy network as a numpy tree (what the runners act
        with)."""
        return tree_to_numpy(self._state[self.POLICY])


class DQNLearner(OffPolicyLearner):
    """Q-network + target network + clip/Adam; the hard target sync
    follows the step count (reference: DQNTorchLearner loss +
    ``target_network_update_freq``). The Q-values are the module's
    ``"pi"`` head, as the JAX learner's ``action_logits``."""

    OPTS = {"opt_state": ("params",)}
    POLICY = "params"

    def __init__(self, module_spec: RLModuleSpec, *, learning_rate: float,
                 gamma: float, grad_clip: Optional[float],
                 target_update_freq: int, double_q: bool, seed: int,
                 device=None):
        device = _learner.learner_device(device)
        self.module = module_spec.build()
        self._gamma = gamma
        self._double_q = double_q
        self._target_every = max(1, target_update_freq)
        params = self.module.init(seed, device=device)
        self._init({"params": params,
                    "target_params": tree_map(torch.clone, params),
                    "steps": 0},
                   {"opt_state": adam(learning_rate, grad_clip)}, device,
                   seed)

    @staticmethod
    def _q_values(params, obs):
        return mlp_forward(params["pi"], obs)

    def _update(self, batch, noise):
        s = self._state
        rows = torch.arange(batch["obs"].shape[0], device=self.device)
        q = self._q_values(s["params"], batch["obs"])
        q_sa = q[rows, batch["actions"]]
        with torch.no_grad():
            q_next_target = self._q_values(s["target_params"],
                                           batch["next_obs"])
            if self._double_q:
                # double-Q: the online net picks, the target net evaluates
                sel = torch.argmax(
                    self._q_values(s["params"], batch["next_obs"]), dim=-1)
                q_next = q_next_target[rows, sel]
            else:
                q_next = torch.max(q_next_target, dim=-1).values
            target = batch["rewards"] + self._gamma \
                * (1.0 - batch["dones"]) * q_next
        td = q_sa - target
        huber = torch.where(torch.abs(td) < 1.0, 0.5 * td ** 2,
                            torch.abs(td) - 0.5)
        loss = torch.mean(huber)
        grads = self._grads("opt_state", loss)
        gnorm = self._apply("opt_state", grads)
        with torch.no_grad():
            s["steps"] += 1
            self._steps += 1
            if self._steps % self._target_every == 0:
                torch._foreach_copy_(tree_leaves(s["target_params"]),
                                     self._leaves["opt_state"])
            return {"qf_loss": loss.detach(), "qf_mean": torch.mean(q_sa),
                    "td_error_abs": torch.mean(torch.abs(td)),
                    "total_loss": loss.detach(), "grad_norm": gnorm}


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.gamma = 0.99
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1_000
        self.rollout_fragment_length = 4
        self.target_network_update_freq = 500   # learner updates
        self.double_q = True
        self.epsilon = [(0, 1.0), (10_000, 0.05)]  # linear schedule
        self.updates_per_step = 8

    def training(self, **kwargs) -> "DQNConfig":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self


class DQN(Algorithm):
    """Env-runner actors fill a replay buffer in this process; the local
    learner (on ``config.learner_device``, the card unless a caller names
    another) trains from it."""

    config_cls = DQNConfig

    #: SAC overrides: Box action spaces need a Gaussian policy, which
    #: plain Q-learning does not have
    supports_continuous = False

    def setup(self, _cfg: Dict) -> None:
        from ray_tpu_torch.rllib.algorithm import spec_for_spaces
        cfg = self.config = self._algo_config
        env_creator = _resolve_env_creator(cfg.env, cfg.env_config)
        probe = env_creator()
        obs_shape = probe.observation_space.shape
        self.module_spec = spec_for_spaces(
            probe.observation_space, probe.action_space,
            cfg.model.get("fcnet_hiddens", (64, 64)),
            dist_for_box="squashed_gaussian")
        if self.module_spec.is_continuous and not self.supports_continuous:
            raise ValueError(
                f"{type(self).__name__} supports Discrete action spaces "
                f"only; use SAC for Box spaces")
        try:
            probe.close()
        except Exception:
            pass
        self.learner = self._make_learner()
        if self.module_spec.is_continuous:
            self.buffer = ReplayBuffer(
                cfg.replay_buffer_capacity, obs_shape, seed=cfg.seed,
                action_shape=(self.module_spec.action_dim,),
                action_dtype=np.float32)
        else:
            self.buffer = ReplayBuffer(
                cfg.replay_buffer_capacity, obs_shape, seed=cfg.seed)
        n_runners = max(1, cfg.num_env_runners)
        runner_cls = ray_tpu_torch.remote(num_cpus=1)(self._runner_cls())
        self.env_runners = [
            runner_cls.remote(env_creator, self.module_spec,
                              cfg.num_envs_per_env_runner, cfg.seed, i)
            for i in range(n_runners)]
        self._sync_weights()
        self._timesteps = 0
        self._return_window: List[float] = []

    # overridable by the off-policy variants, so setup() builds the
    # right learner and runners once
    def _make_learner(self):
        cfg = self.config
        return DQNLearner(
            self.module_spec, learning_rate=cfg.lr, gamma=cfg.gamma,
            grad_clip=cfg.grad_clip,
            target_update_freq=cfg.target_network_update_freq,
            double_q=cfg.double_q, seed=cfg.seed,
            device=cfg.learner_device)

    def _runner_cls(self):
        return DQNEnvRunner

    def _sync_weights(self) -> None:
        w_ref = ray_tpu_torch.put(self.learner.get_weights())
        ray_tpu_torch.get([r.set_weights.remote(w_ref)
                           for r in self.env_runners])

    def _epsilon(self) -> float:
        pts = self.config.epsilon
        t = self._timesteps
        for (t0, e0), (t1, e1) in zip(pts, pts[1:]):
            if t < t1:
                frac = (t - t0) / max(1, t1 - t0)
                return float(e0 + (e1 - e0) * min(1.0, max(0.0, frac)))
        return float(pts[-1][1])

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        batches = ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length, eps)
             for r in self.env_runners])
        for b in batches:
            self.buffer.add_batch(b)
            self._timesteps += len(b["obs"])

        metrics: Dict[str, float] = {}
        if self._timesteps >= cfg.num_steps_sampled_before_learning_starts:
            if cfg.updates_per_step > 1:
                metrics = self.learner.update_many(
                    self.buffer.sample_many(cfg.updates_per_step,
                                            cfg.train_batch_size))
                self._sync_weights()
            elif cfg.updates_per_step == 1:
                metrics = self.learner.update(
                    self.buffer.sample(cfg.train_batch_size))
                self._sync_weights()
            # updates_per_step == 0: collection only, no training

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
            "episode_reward_mean": mean_return,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "epsilon": eps,
            "learner": metrics,
        }

    def train(self) -> Dict[str, Any]:
        return Algorithm.train(self)

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        """``algo_state.pkl``: the learner's state with numpy leaves (its
        ``state_numpy``) and the step count."""
        import os
        import pickle
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "wb") as f:
            pickle.dump({"state": self.learner.state_numpy(),
                         "timesteps": self._timesteps}, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"),
                  "rb") as f:
            blob = pickle.load(f)
        self.learner.load_state(blob["state"])
        self._timesteps = blob["timesteps"]
        self._sync_weights()

    def get_policy_weights(self):
        return self.learner.get_weights()

    def compute_single_action(self, obs: np.ndarray) -> int:
        w = self.learner.get_weights()
        return int(self.module_spec.build().forward_inference(
            w, obs[None])[0])

    def cleanup(self) -> None:
        for r in getattr(self, "env_runners", []):
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
