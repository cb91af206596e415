"""Offline RL: dataset IO + behavior cloning + MARWIL, the port of
``ray_tpu/rllib/offline.py``.

Reference: ``rllib/offline/`` (``json_reader.py``/``json_writer.py``
SampleBatch IO, ``dataset_reader.py``) and the algorithms
``rllib/algorithms/bc/bc.py`` and ``rllib/algorithms/marwil/marwil.py``
(advantage-weighted behavior cloning). Both losses run on the port's
``Learner``/``LearnerGroup`` (the local learner on
``config.learner_device``, the card unless a caller names another); the
reader hands out numpy batches, so training needs no environment. The
files are the JAX package's format, one JSON object of lists a line:
either package reads what the other wrote, in the same sample order.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, _resolve_env_creator
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.rl_module import RLModuleSpec


# ------------------------------------------------------------------ IO
class JsonWriter:
    """Writes rollout batches as JSON lines (reference:
    ``offline/json_writer.py``: one SampleBatch a line)."""

    def __init__(self, path: str, max_file_size: int = 64 << 20):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_file_size = max_file_size
        self._index = 0
        self._f = None

    def _file(self):
        if self._f is None or self._f.tell() > self.max_file_size:
            if self._f:
                self._f.close()
            self._index += 1
            self._f = open(os.path.join(
                self.path, f"output-{self._index:05d}.json"), "w")
        return self._f

    def write(self, batch: Dict[str, np.ndarray]) -> None:
        row = {k: np.asarray(v).tolist() for k, v in batch.items()}
        f = self._file()
        f.write(json.dumps(row) + "\n")
        f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class JsonReader:
    """Reads JSON-lines batches; shuffles rows into sample batches with a
    numpy generator seeded as the JAX reader's."""

    def __init__(self, paths, seed: int = 0):
        if isinstance(paths, str):
            paths = [paths]
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                files.extend(sorted(_glob.glob(os.path.join(p, "*.json"))))
            else:
                files.extend(sorted(_glob.glob(p)) or [p])
        if not files:
            raise FileNotFoundError(f"no offline data under {paths!r}")
        batches = []
        for fp in files:
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        batches.append({
                            k: np.asarray(v)
                            for k, v in json.loads(line).items()})
        self._data = {
            k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}
        self._n = len(self._data["obs"])
        self._rng = np.random.default_rng(seed)

    @property
    def num_samples(self) -> int:
        return self._n

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._n, size=batch_size)
        return {k: v[idx] for k, v in self._data.items()}

    def iter_epochs(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        perm = self._rng.permutation(self._n)
        for s in range(0, self._n, batch_size):
            idx = perm[s:s + batch_size]
            yield {k: v[idx] for k, v in self._data.items()}


def compute_monte_carlo_returns(rewards: np.ndarray, dones: np.ndarray,
                                gamma: float) -> np.ndarray:
    """Discounted returns per step (episode-bounded), for MARWIL's
    advantage estimate over offline data."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in reversed(range(len(rewards))):
        acc = rewards[t] + gamma * acc * (1.0 - dones[t])
        out[t] = acc
    return out


# -------------------------------------------------------------- losses
def _taken_logp(logits: torch.Tensor, actions: torch.Tensor):
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions[:, None])[:, 0]


def bc_loss(fwd_out: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], *,
            entropy_coeff: float = 0.0):
    logp_all, logp = _taken_logp(fwd_out["action_logits"], batch["actions"])
    policy_loss = -torch.mean(logp)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
    total = policy_loss - entropy_coeff * entropy
    return total, {"policy_loss": policy_loss, "entropy": entropy}


def marwil_loss(fwd_out: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], *,
                beta: float = 1.0,
                vf_loss_coeff: float = 1.0):
    """Advantage-weighted BC (reference: marwil torch learner): weight
    each log-prob by exp(beta * normalized advantage), the exponent
    clipped at +-10; advantages are the Monte-Carlo return less the
    learned value baseline, normalized by the batch's own RMS advantage
    under stop-gradient."""
    _, logp = _taken_logp(fwd_out["action_logits"], batch["actions"])
    adv = batch["returns"] - fwd_out["vf_preds"]
    vf_loss = 0.5 * torch.mean(torch.square(adv))
    adv_sg = adv.detach()
    norm = torch.sqrt(torch.mean(torch.square(adv_sg)) + 1e-8)
    weights = torch.exp(torch.clamp(beta * adv_sg / norm, -10.0, 10.0))
    policy_loss = -torch.mean(weights * logp)
    total = policy_loss + vf_loss_coeff * vf_loss
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                   "mean_weight": torch.mean(weights)}


# ---------------------------------------------------------- algorithms
class _OfflineAlgorithm(Algorithm):
    """Shared driver: no env runners; batches come from the reader.
    If ``config.env`` is set, each step also rolls out a few evaluation
    episodes (on the CPU) to report ``episode_return_mean``."""

    def setup(self, _cfg: Dict) -> None:
        cfg = self.config = self._algo_config
        if not getattr(cfg, "offline_data", None):
            raise ValueError("offline algorithms need config.offline_data")
        self.reader = JsonReader(cfg.offline_data, seed=cfg.seed)
        self._prepare_reader_extras()

        obs_dim = int(np.prod(np.shape(
            self.reader._data["obs"][0])))
        num_actions = int(self.reader._data["actions"].max()) + 1
        if cfg.env is not None:
            env_creator = _resolve_env_creator(cfg.env, cfg.env_config)
            probe = env_creator()
            obs_dim = int(np.prod(probe.observation_space.shape))
            num_actions = int(probe.action_space.n)
            self._eval_env = env_creator()
        else:
            self._eval_env = None
        self.module_spec = RLModuleSpec(
            observation_dim=obs_dim, num_actions=num_actions,
            hiddens=tuple(cfg.model.get("fcnet_hiddens", (64, 64))))
        spec, loss_fn = self.module_spec, self.loss_fn()
        loss_config = self.loss_config()
        lr, clip, seed = cfg.lr, cfg.grad_clip, cfg.seed
        # remote learners name no device (see algorithm.py's docstring)
        device = cfg.learner_device if cfg.num_learners == 0 else None

        def make_learner() -> Learner:
            return Learner(spec, loss_fn, learning_rate=lr,
                           grad_clip=clip, seed=seed,
                           loss_config=loss_config, device=device)

        self.learner_group = LearnerGroup(
            make_learner, num_learners=cfg.num_learners, seed=cfg.seed)
        self._inference_module = spec.build()
        self._cached_weights = None
        self.env_runners = []
        self._timesteps = 0
        self._return_window: List[float] = []

    def _prepare_reader_extras(self) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.reader.sample(cfg.train_batch_size)
        metrics = self.learner_group.update_from_batch(
            batch, minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs)
        self._timesteps += cfg.train_batch_size
        out = {
            "num_env_steps_trained_lifetime": self._timesteps,
            "learner": metrics,
        }
        if self._eval_env is not None:
            out["episode_return_mean"] = self._evaluate(episodes=2)
            out["episode_reward_mean"] = out["episode_return_mean"]
        return out

    def _evaluate(self, episodes: int = 2) -> float:
        self._cached_weights = self.learner_group.get_weights()
        totals = []
        for _ in range(episodes):
            out = self._eval_env.reset()
            obs = out[0] if isinstance(out, tuple) else out
            total, done = 0.0, False
            for _ in range(1000):
                a = self._inference_module.forward_inference(
                    self._cached_weights, np.asarray([obs]))
                step = self._eval_env.step(int(a[0]))
                if len(step) == 5:
                    obs, r, term, trunc, _ = step
                    done = term or trunc
                else:
                    obs, r, done, _ = step
                total += float(r)
                if done:
                    break
            totals.append(total)
        self._return_window.extend(totals)
        self._return_window = self._return_window[-100:]
        return float(np.mean(self._return_window))

    def cleanup(self) -> None:
        if self._eval_env is not None:
            try:
                self._eval_env.close()
            except Exception:
                pass
        self.learner_group.shutdown()


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.offline_data: Optional[Any] = None
        self.entropy_coeff: float = 0.0
        self.lr = 1e-3
        self.num_epochs = 1
        self.minibatch_size = None
        self.env = None

    def offline_data_paths(self, paths) -> "BCConfig":
        self.offline_data = paths
        return self


class BC(_OfflineAlgorithm):
    config_cls = BCConfig

    def loss_fn(self):
        return bc_loss

    def loss_config(self) -> Dict[str, Any]:
        return {"entropy_coeff": self.config.entropy_coeff}


class MARWILConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.offline_data: Optional[Any] = None
        self.beta: float = 1.0
        self.vf_loss_coeff: float = 1.0
        self.lr = 1e-3
        self.num_epochs = 1
        self.minibatch_size = None
        self.env = None


class MARWIL(_OfflineAlgorithm):
    config_cls = MARWILConfig

    def loss_fn(self):
        return marwil_loss

    def loss_config(self) -> Dict[str, Any]:
        return {"beta": self.config.beta,
                "vf_loss_coeff": self.config.vf_loss_coeff}

    def _prepare_reader_extras(self) -> None:
        d = self.reader._data
        if "returns" not in d:
            d["returns"] = compute_monte_carlo_returns(
                d["rewards"].astype(np.float32),
                d["dones"].astype(np.float32), self.config.gamma)
