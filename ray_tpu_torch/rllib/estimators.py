"""Off-policy evaluation: estimate a target policy's value from
behavior data without running it in the environment, the port of
``ray_tpu/rllib/estimators.py``.

Reference: ``rllib/offline/estimators/`` —
``importance_sampling.py`` (IS), ``weighted_importance_sampling.py``
(WIS), ``direct_method.py`` (DM over a fitted-Q model) and
``doubly_robust.py`` (DR). Estimators consume episode-structured
batches carrying behavior action log-probs (``logp``) and a
``target_logp_fn(obs, actions) -> logp`` for the evaluated policy. The
estimators are numpy; the FQE model behind DM/DR is a small TD
regression trained with Adam on its device (the card unless a caller
names another), its minibatches drawn as the JAX package's are.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from ray_tpu_torch.models.training import ClipAdamW, global_norm
from ray_tpu_torch.rllib import learner as _learner
from ray_tpu_torch.rllib.models import (init_mlp, mlp_forward, tree_get,
                                        tree_map, tree_paths, tree_to_tensors)


def split_episodes(batch: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Split a flat step batch into episodes at done=1 boundaries."""
    dones = np.asarray(batch["dones"]).astype(bool)
    out = []
    start = 0
    for t, d in enumerate(dones):
        if d:
            out.append({k: np.asarray(v)[start:t + 1]
                        for k, v in batch.items()})
            start = t + 1
    if start < len(dones):
        out.append({k: np.asarray(v)[start:]
                    for k, v in batch.items()})
    return [e for e in out if len(e["obs"])]


def _episode_weights(ep: Dict[str, np.ndarray], target_logp_fn) -> np.ndarray:
    """Cumulative importance ratios w_t = prod_{i<=t} pi(a|s)/b(a|s)."""
    tlogp = np.asarray(target_logp_fn(ep["obs"], ep["actions"]),
                       np.float64)
    blogp = np.asarray(ep["logp"], np.float64)
    # clip per-step log-ratios: one pathological step otherwise blows
    # the product past float range (reference clips ratios similarly)
    step = np.clip(tlogp - blogp, -20.0, 20.0)
    return np.exp(np.cumsum(step))


class ImportanceSampling:
    """Per-step IS (reference: importance_sampling.py): V = E over
    episodes of sum_t gamma^t w_t r_t."""

    def __init__(self, target_logp_fn: Callable, gamma: float = 0.99):
        self.target_logp_fn = target_logp_fn
        self.gamma = gamma

    def estimate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        vals, behavior = [], []
        for ep in split_episodes(batch):
            w = _episode_weights(ep, self.target_logp_fn)
            g = self.gamma ** np.arange(len(w))
            r = np.asarray(ep["rewards"], np.float64)
            vals.append(float(np.sum(g * w * r)))
            behavior.append(float(np.sum(g * r)))
        return {"v_target": float(np.mean(vals)),
                "v_behavior": float(np.mean(behavior)),
                "num_episodes": len(vals)}


class WeightedImportanceSampling:
    """Per-step WIS (reference: weighted_importance_sampling.py):
    ratios are normalized by their per-timestep mean across episodes —
    biased but far lower variance than IS."""

    def __init__(self, target_logp_fn: Callable, gamma: float = 0.99):
        self.target_logp_fn = target_logp_fn
        self.gamma = gamma

    def estimate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        eps = split_episodes(batch)
        ws = [_episode_weights(ep, self.target_logp_fn) for ep in eps]
        T = max((len(w) for w in ws), default=0)
        # mean cumulative ratio at each t over episodes still running
        norm = np.zeros(T)
        cnt = np.zeros(T)
        for w in ws:
            norm[:len(w)] += w
            cnt[:len(w)] += 1
        norm = norm / np.maximum(cnt, 1)
        vals, behavior = [], []
        for ep, w in zip(eps, ws):
            g = self.gamma ** np.arange(len(w))
            r = np.asarray(ep["rewards"], np.float64)
            wn = w / np.maximum(norm[:len(w)], 1e-12)
            vals.append(float(np.sum(g * wn * r)))
            behavior.append(float(np.sum(g * r)))
        return {"v_target": float(np.mean(vals)),
                "v_behavior": float(np.mean(behavior)),
                "num_episodes": len(vals)}


class FQEModel:
    """Fitted Q evaluation (reference: ``fqe_torch_model.py``): a small
    Q(s, .) MLP trained by TD toward the target policy's expectation over
    the next state's actions, with Adam (no clip) on ``device``."""

    def __init__(self, obs_dim: int, num_actions: int,
                 target_probs_fn: Callable, gamma: float = 0.99,
                 lr: float = 1e-3, hiddens=(64, 64), seed: int = 0,
                 device=None):
        self.device = _learner.learner_device(device)
        self.num_actions = num_actions
        self.target_probs_fn = target_probs_fn
        self.gamma = gamma
        self._opt = ClipAdamW(lr, b1=0.9, b2=0.999, eps=1e-8,
                              weight_decay=0.0, clip_norm=None)
        self.load_params(init_mlp(torch.Generator().manual_seed(seed),
                                  [obs_dim, *hiddens, num_actions]))

    def load_params(self, params) -> None:
        """Take a Q-network (a tree of numpy arrays or tensors in the
        layout of ``models.init_mlp``) with fresh Adam moments."""
        self._params = tree_to_tensors(params, self.device)
        self._paths = tree_paths(self._params)
        self._leaves = [tree_get(self._params, p) for p in self._paths]
        for leaf in self._leaves:
            leaf.requires_grad_(True)
        self._opt_state = {
            "count": torch.zeros((), dtype=torch.int32, device=self.device),
            "mu": tree_map(torch.zeros_like, self._params),
            "nu": tree_map(torch.zeros_like, self._params)}

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        p = self._params
        q = mlp_forward(p, batch["obs"])
        rows = torch.arange(q.shape[0], device=self.device)
        q_sa = q[rows, batch["actions"]]
        with torch.no_grad():
            v_next = torch.sum(batch["next_probs"]
                               * mlp_forward(p, batch["next_obs"]), dim=-1)
            y = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) \
                * v_next
        loss = torch.mean((q_sa - y) ** 2)
        grads = list(torch.autograd.grad(loss, self._leaves))
        with torch.no_grad():
            self._opt.update(grads, self._opt_state, self._leaves,
                             global_norm(grads), paths=self._paths)
        return loss.detach()

    def train(self, batch: Dict[str, np.ndarray], iters: int = 200,
              minibatch: int = 256, seed: int = 0) -> float:
        """``iters`` Adam steps on minibatches drawn with
        ``default_rng(seed)``; returns the last step's loss."""
        rng = np.random.default_rng(seed)
        n = len(batch["obs"])
        next_probs = np.asarray(
            self.target_probs_fn(batch["next_obs"]), np.float32)
        data = _learner._batch_tensors(
            {"obs": batch["obs"], "next_obs": batch["next_obs"],
             "actions": batch["actions"], "rewards": batch["rewards"],
             "dones": batch["dones"], "next_probs": next_probs},
            self.device)
        loss = torch.zeros((), device=self.device)
        for _ in range(iters):
            idx = torch.as_tensor(rng.integers(0, n, size=min(minibatch, n)),
                                  device=self.device)
            loss = self._step({k: v[idx] for k, v in data.items()})
        return float(loss)

    @torch.no_grad()
    def q_values(self, obs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        return mlp_forward(self._params, x).cpu().numpy()

    def v_values(self, obs: np.ndarray) -> np.ndarray:
        probs = np.asarray(self.target_probs_fn(obs), np.float64)
        return np.sum(probs * self.q_values(obs), axis=-1)


class DirectMethod:
    """DM (reference: direct_method.py): V = E[ V_FQE(s_0) ]."""

    def __init__(self, fqe: FQEModel):
        self.fqe = fqe

    def estimate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        eps = split_episodes(batch)
        v0 = [float(self.fqe.v_values(ep["obs"][:1])[0]) for ep in eps]
        return {"v_target": float(np.mean(v0)),
                "num_episodes": len(v0)}


class DoublyRobust:
    """DR (reference: doubly_robust.py): the DM baseline plus the
    importance-weighted TD correction — unbiased like IS, low-variance
    like DM."""

    def __init__(self, fqe: FQEModel, target_logp_fn: Callable,
                 gamma: float = 0.99):
        self.fqe = fqe
        self.target_logp_fn = target_logp_fn
        self.gamma = gamma

    def estimate(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        vals = []
        for ep in split_episodes(batch):
            obs = np.asarray(ep["obs"], np.float64)
            acts = np.asarray(ep["actions"])
            r = np.asarray(ep["rewards"], np.float64)
            T = len(r)
            w = _episode_weights(ep, self.target_logp_fn)
            w_prev = np.concatenate([[1.0], w[:-1]])
            q = self.fqe.q_values(ep["obs"])
            q_sa = q[np.arange(T), acts]
            v = self.fqe.v_values(ep["obs"])
            # bootstrap from the actual next states: a truncated
            # trailing episode's final step must use V(s_{T+1}), not 0
            # (the batch carries next_obs; dones zeroes the terminal
            # case below either way)
            v_next = self.fqe.v_values(ep["next_obs"])
            dones = np.asarray(ep["dones"], np.float64)
            g = self.gamma ** np.arange(T)
            correction = w * (r + self.gamma * (1 - dones) * v_next
                              - q_sa)
            vals.append(float(v[0] + np.sum(g * correction)))
        return {"v_target": float(np.mean(vals)),
                "num_episodes": len(vals)}
