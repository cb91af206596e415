"""Vanilla policy gradient (REINFORCE with baseline), the port of
``ray_tpu/rllib/pg.py``.

Reference: the (contrib) PG algorithm — simplest on-policy baseline,
sharing the PPO batch format and runner stack.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.ppo import categorical_logp, normalize


def pg_loss(fwd_out, batch, *, vf_loss_coeff: float = 0.5):
    values = fwd_out["vf_preds"]
    logp, _ = categorical_logp(fwd_out["action_logits"], batch["actions"])
    adv = normalize(batch["advantages"])
    policy_loss = -torch.mean(logp * adv)
    vf_loss = torch.mean(torch.square(values - batch["value_targets"]))
    total = policy_loss + vf_loss_coeff * vf_loss
    return total, {"policy_loss": policy_loss, "vf_loss": vf_loss}


class PGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PG)
        self.vf_loss_coeff: float = 0.5
        self.lambda_: float = 1.0
        self.num_epochs = 1


class PG(Algorithm):
    config_cls = PGConfig

    def loss_fn(self):
        return pg_loss

    def loss_config(self) -> Dict[str, Any]:
        return {"vf_loss_coeff": self.config.vf_loss_coeff}
