"""IMPALA: importance-weighted actor-learner architecture, the port of
``ray_tpu/rllib/impala.py``.

Reference: ``rllib/algorithms/impala/impala.py`` (decoupled sampling and
learning with V-trace off-policy correction; torch loss in
``impala/torch/impala_torch_learner.py``). The V-trace recursion runs
inside the loss on the learner's device, as a loop over the time axis
from the last step back (JAX's reversed ``lax.scan``); its targets carry
no gradient (``detach`` for ``stop_gradient``). Batches stay time-major,
row ``t*B + b``. Weights broadcast to runners every
``broadcast_interval`` iterations, so sample batches are mildly stale and
V-trace's clipped importance ratios (rho/c) do the correction.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.ppo import categorical_entropy, categorical_logp


@torch.no_grad()
def vtrace_returns(target_logp, behavior_logp, rewards, values,
                   bootstrap_value, dones, gamma: float,
                   rho_clip: float, c_clip: float):
    """V-trace targets vs_t and policy-gradient advantages, [T, B], with
    no gradient.

    vs_t = V(x_t) + sum_k gamma^k (prod c) delta_k, computed as the
    backward recursion acc_t = delta_t + discount_t c_t acc_{t+1} from
    acc_T = 0, the bootstrap value standing in for V(x_T).
    """
    log_ratio = target_logp - behavior_logp
    rho = torch.clamp(torch.exp(log_ratio), max=rho_clip)
    c = torch.clamp(torch.exp(log_ratio), max=c_clip)
    discount = gamma * (1.0 - dones)
    values_tp1 = torch.cat([values[1:], bootstrap_value[None, :]], dim=0)
    deltas = rho * (rewards + discount * values_tp1 - values)
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = torch.empty_like(deltas)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discount[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None, :]], dim=0)
    pg_adv = rho * (rewards + discount * vs_tp1 - values)
    return vs, pg_adv


def time_major(fwd_out, batch, rollout_len: int):
    """The loss inputs as [T, B]: the target log-probs (with gradient),
    the behaviour log-probs, values, rewards, dones, plus the log-softmax
    [T*B, A] and the bootstrap values [B]."""
    T = rollout_len
    logits = fwd_out["action_logits"]          # [T*B, A] time-major
    B = logits.shape[0] // T
    logp_act, logp_all = categorical_logp(logits, batch["actions"])

    def tb(x):
        return x.reshape(T, B)
    return (tb(logp_act), tb(batch["behavior_logp"]),
            tb(fwd_out["vf_preds"]), tb(batch["rewards"]),
            tb(batch["dones"]), logp_all, batch["bootstrap_value"])


def impala_loss(fwd_out: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], *,
                rollout_len: int = 40,
                gamma: float = 0.99,
                vf_loss_coeff: float = 0.5,
                entropy_coeff: float = 0.01,
                rho_clip: float = 1.0,
                c_clip: float = 1.0):
    (target_logp, behavior_logp, values, rewards, dones, logp_all,
     bootstrap) = time_major(fwd_out, batch, rollout_len)
    vs, pg_adv = vtrace_returns(
        target_logp, behavior_logp, rewards, values, bootstrap, dones,
        gamma, rho_clip, c_clip)

    policy_loss = -torch.mean(target_logp * pg_adv)
    vf_loss = 0.5 * torch.mean(torch.square(vs - values))
    entropy = categorical_entropy(logp_all)
    total = policy_loss + vf_loss_coeff * vf_loss \
        - entropy_coeff * entropy
    metrics = {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "mean_rho": torch.mean(torch.exp(target_logp - behavior_logp)),
    }
    return total, metrics


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.rollout_len: int = 40
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.vtrace_rho_clip: float = 1.0
        self.vtrace_c_clip: float = 1.0
        #: sync weights to runners every N iterations (1 = on-policy-ish)
        self.broadcast_interval: int = 1
        self.lr = 5e-4
        self.num_epochs = 1
        self.minibatch_size = None


class IMPALA(Algorithm):
    config_cls = IMPALAConfig

    def loss_fn(self):
        return impala_loss

    def loss_config(self) -> Dict[str, Any]:
        c = self.config
        return {
            "rollout_len": c.rollout_len,
            "gamma": c.gamma,
            "vf_loss_coeff": c.vf_loss_coeff,
            "entropy_coeff": c.entropy_coeff,
            "rho_clip": c.vtrace_rho_clip,
            "c_clip": c.vtrace_c_clip,
        }

    def setup(self, cfg_dict: Dict) -> None:
        super().setup(cfg_dict)
        self._iter_count = 0

    def step(self) -> Dict[str, Any]:
        cfg = self.config
        T = cfg.rollout_len
        futs = [r.sample_segments.remote(T) for r in self.env_runners]
        batches = ray_tpu_torch.get(futs)
        # concat along the ENV axis (axis=1 of [T, B_i, ...]), then
        # flatten time-major so index t*B+b matches the loss's reshape
        seg = {k: np.concatenate([b[k] for b in batches], axis=1)
               for k in batches[0] if k != "bootstrap_value"}
        B = seg["actions"].shape[1]
        flat = {k: v.reshape((T * B,) + v.shape[2:])
                for k, v in seg.items()}
        flat["bootstrap_value"] = np.concatenate(
            [b["bootstrap_value"] for b in batches], axis=0)
        self._timesteps += T * B

        metrics = self.learner_group.update_ordered(flat)
        self._iter_count += 1
        if self._iter_count % max(1, cfg.broadcast_interval) == 0:
            self._sync_weights()

        returns = []
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
            "learner": metrics,
        }
