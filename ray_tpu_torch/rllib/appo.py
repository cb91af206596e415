"""APPO: asynchronous PPO — PPO's clipped surrogate on IMPALA's decoupled
sampling with V-trace off-policy correction, the port of
``ray_tpu/rllib/appo.py``.

Reference: ``rllib/algorithms/appo/appo.py`` (APPOConfig: vtrace=True,
clip_param, use_kl_loss/kl_coeff) and the loss in
``appo/appo_learner.py`` + ``appo/torch/appo_torch_learner.py``
(surrogate clip over V-trace pg advantages, value loss against vs
targets, entropy bonus, KL regularizer toward the behaviour policy).
Staleness between the learner policy and the sampling policy is the
async part: weights broadcast every ``broadcast_interval`` iterations and
the importance ratios correct the drift.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.impala import (IMPALA, IMPALAConfig, time_major,
                                        vtrace_returns)
from ray_tpu_torch.rllib.ppo import categorical_entropy, normalize


def appo_loss(fwd_out: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor], *,
              rollout_len: int = 40,
              gamma: float = 0.99,
              clip_param: float = 0.2,
              vf_loss_coeff: float = 0.5,
              entropy_coeff: float = 0.01,
              kl_coeff: float = 0.0,
              rho_clip: float = 1.0,
              c_clip: float = 1.0):
    (target_logp, behavior_logp, values, rewards, dones, logp_all,
     bootstrap) = time_major(fwd_out, batch, rollout_len)
    vs, pg_adv = vtrace_returns(
        target_logp, behavior_logp, rewards, values, bootstrap, dones,
        gamma, rho_clip, c_clip)
    adv = normalize(pg_adv)

    # PPO clip on the off-policy ratio (reference: appo_learner computes
    # logp_ratio against the BEHAVIOUR policy when vtrace is on)
    ratio = torch.exp(target_logp - behavior_logp)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv
    policy_loss = -torch.mean(torch.minimum(surr1, surr2))

    vf_loss = 0.5 * torch.mean(torch.square(vs - values))
    entropy = categorical_entropy(logp_all)
    # KL(behaviour || target) estimator over sampled actions: restrains
    # the update from straying far from the sampling policy
    mean_kl = torch.mean(behavior_logp - target_logp)

    total = policy_loss + vf_loss_coeff * vf_loss \
        - entropy_coeff * entropy + kl_coeff * mean_kl
    metrics = {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "mean_kl": mean_kl,
        "mean_rho": torch.mean(ratio),
    }
    return total, metrics


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.clip_param: float = 0.2
        self.use_kl_loss: bool = False
        self.kl_coeff: float = 0.2
        self.lr = 5e-4
        #: APPO default broadcast is less frequent than IMPALA's — the
        #: clip + vtrace tolerate staler batches
        self.broadcast_interval: int = 2


class APPO(IMPALA):
    config_cls = APPOConfig

    def loss_fn(self):
        return appo_loss

    def loss_config(self) -> Dict[str, Any]:
        c = self.config
        return {
            "rollout_len": c.rollout_len,
            "gamma": c.gamma,
            "clip_param": c.clip_param,
            "vf_loss_coeff": c.vf_loss_coeff,
            "entropy_coeff": c.entropy_coeff,
            "kl_coeff": c.kl_coeff if c.use_kl_loss else 0.0,
            "rho_clip": c.vtrace_rho_clip,
            "c_clip": c.vtrace_c_clip,
        }
