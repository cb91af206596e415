"""RLModule: the policy abstraction shared by learner and env runners, the
port of ``ray_tpu/rllib/rl_module.py``.

Reference: ``rllib/core/rl_module/rl_module.py`` —
``forward_inference`` / ``forward_exploration`` / ``forward_train`` over
one parameter tree. The train forward runs inside the Learner's update
on its device (the card by default); the exploration and inference
forwards are numpy in, numpy out, on ``torch.device("cpu")``: env runners
are CPU actors by design, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.rllib.models import (
    actor_critic_forward, diag_gaussian_logp,
    gaussian_actor_critic_forward, init_actor_critic,
    init_gaussian_actor_critic, tree_map)

#: where the exploration and inference forwards run
ROLLOUT_DEVICE = torch.device("cpu")


@dataclasses.dataclass
class RLModuleSpec:
    observation_dim: int
    num_actions: int = 0
    hiddens: tuple = (64, 64)
    #: "categorical" (Discrete) or "gaussian" (Box — diagonal Gaussian,
    #: unsquashed; the env-runner clips to the space bounds like the
    #: reference's TorchDiagGaussian + action clipping)
    dist: str = "categorical"
    action_dim: int = 0
    action_low: tuple = ()
    action_high: tuple = ()

    @property
    def is_continuous(self) -> bool:
        return self.dist != "categorical"

    def build(self) -> "RLModule":
        return RLModule(self)


def _as_generator(key: Union[int, torch.Generator]) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def _rollout_params(params) -> Dict:
    """A weights tree (numpy arrays or tensors) as f32 CPU tensors; numpy
    leaves are viewed, not copied."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(ROLLOUT_DEVICE, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32))
    return tree_map(one, params)


class RLModule:
    def __init__(self, spec: RLModuleSpec):
        self.spec = spec

    def init(self, key: Union[int, torch.Generator] = 0,
             device=None) -> Dict:
        """A fresh parameter tree drawn from ``key`` (a ``torch.Generator``
        or an int seed), f32, on ``device`` (the generator's by default)."""
        gen = _as_generator(key)
        if self.spec.is_continuous:
            params = init_gaussian_actor_critic(
                gen, self.spec.observation_dim, self.spec.action_dim,
                self.spec.hiddens)
        else:
            params = init_actor_critic(
                gen, self.spec.observation_dim, self.spec.num_actions,
                self.spec.hiddens)
        if device is not None:
            params = tree_map(lambda t: t.to(device), params)
        return params

    # -- train path (inside the learner's update) ----------------------
    def forward_train(self, params: Dict, obs: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        if self.spec.is_continuous:
            mean, log_std, value = gaussian_actor_critic_forward(
                params, obs)
            return {"action_mean": mean, "action_log_std": log_std,
                    "vf_preds": value}
        logits, value = actor_critic_forward(params, obs)
        return {"action_logits": logits, "vf_preds": value}

    # -- rollout path (CPU) --------------------------------------------
    @torch.no_grad()
    def forward_exploration(self, params: Dict, obs: np.ndarray,
                            generator: torch.Generator
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample actions for ``obs`` on the CPU with ``generator``;
        returns numpy (action, logp, value)."""
        params = _rollout_params(params)
        x = torch.as_tensor(np.asarray(obs, np.float32))
        if self.spec.is_continuous:
            mean, log_std, value = gaussian_actor_critic_forward(params, x)
            noise = torch.randn(mean.shape, generator=generator,
                                dtype=mean.dtype)
            action = mean + torch.exp(log_std) * noise
            logp = diag_gaussian_logp(mean, log_std, action)
        else:
            logits, value = actor_critic_forward(params, x)
            logp_all = torch.log_softmax(logits, dim=-1)
            action = torch.multinomial(torch.exp(logp_all), 1,
                                       generator=generator)[:, 0]
            logp = logp_all.gather(-1, action[:, None])[:, 0]
        return action.numpy(), logp.numpy(), value.numpy()

    @torch.no_grad()
    def forward_inference(self, params: Dict, obs: np.ndarray
                          ) -> np.ndarray:
        params = _rollout_params(params)
        x = torch.as_tensor(np.asarray(obs, np.float32))
        if self.spec.is_continuous:
            mean, _, _ = gaussian_actor_critic_forward(params, x)
            return np.clip(mean.numpy(),
                           np.asarray(self.spec.action_low, np.float32),
                           np.asarray(self.spec.action_high, np.float32))
        logits, _ = actor_critic_forward(params, x)
        return torch.argmax(logits, dim=-1).numpy()
