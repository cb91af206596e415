"""PPO: clipped-surrogate policy optimization, the port of
``ray_tpu/rllib/ppo.py``.

Reference: ``rllib/algorithms/ppo/ppo.py`` and the torch loss in
``ppo/torch/ppo_torch_learner.py``: clip objective, value-function loss
with clipping, entropy bonus. The loss runs inside the learner's update
on its device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.models import (diag_gaussian_entropy,
                                        diag_gaussian_logp)


def normalize(adv: torch.Tensor) -> torch.Tensor:
    """Advantages at zero mean and unit population std (``jnp.std``'s,
    not ``torch.std``'s unbiased default)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def categorical_logp(logits: torch.Tensor, actions: torch.Tensor):
    """(log-probabilities of ``actions`` [B], log-softmax [B, A])."""
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all.gather(-1, actions.long()[:, None])[:, 0], logp_all


def categorical_entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def ppo_loss(fwd_out: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor], *,
             clip_param: float = 0.2,
             vf_loss_coeff: float = 0.5,
             entropy_coeff: float = 0.0,
             vf_clip_param: float = 10.0):
    values = fwd_out["vf_preds"]
    if "action_mean" in fwd_out:
        # Box space: diagonal Gaussian (reference: TorchDiagGaussian in
        # ppo_torch_learner — same clip objective over continuous logp)
        log_std = fwd_out["action_log_std"]
        logp = diag_gaussian_logp(fwd_out["action_mean"], log_std,
                                  batch["actions"])
        entropy = torch.mean(diag_gaussian_entropy(log_std))
    else:
        logp, logp_all = categorical_logp(fwd_out["action_logits"],
                                          batch["actions"])
        entropy = categorical_entropy(logp_all)

    adv = normalize(batch["advantages"])
    ratio = torch.exp(logp - batch["logp"])
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv
    policy_loss = -torch.mean(torch.minimum(surr1, surr2))

    vf_err = torch.square(values - batch["value_targets"])
    vf_loss = torch.mean(torch.clamp(vf_err, 0.0, vf_clip_param ** 2))

    total = policy_loss + vf_loss_coeff * vf_loss \
        - entropy_coeff * entropy
    metrics = {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "mean_kl": torch.mean(batch["logp"] - logp),
    }
    return total, metrics


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.clip_param: float = 0.2
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.0
        self.vf_clip_param: float = 10.0
        self.lambda_: float = 0.95
        self.lr = 5e-5
        self.num_epochs = 8
        self.minibatch_size = 128


class PPO(Algorithm):
    config_cls = PPOConfig
    supports_continuous = True

    def loss_fn(self):
        return ppo_loss

    def loss_config(self) -> Dict[str, Any]:
        c = self.config
        return {
            "clip_param": c.clip_param,
            "vf_loss_coeff": c.vf_loss_coeff,
            "entropy_coeff": c.entropy_coeff,
            "vf_clip_param": c.vf_clip_param,
        }
