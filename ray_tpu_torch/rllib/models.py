"""Policy/value networks as plain PyTorch functions, the port of
``ray_tpu/rllib/models.py``.

Parameters are a tree in the JAX package's layout: a list of
``{"w": [fan_in, fan_out], "b": [fan_out]}`` dicts per network, computed
as ``x @ w + b`` (not ``nn.Linear``'s ``[out, in]``), under ``"pi"`` and
``"vf"``. So ``get_weights()`` numpy trees, and the checkpoints that hold
them, move between the two packages unchanged. Initialisation draws from
an explicit ``torch.Generator``; forwards are pure functions of the tree,
so the learner's update and the env runners' CPU inference share them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- trees
def tree_paths(tree, prefix=()) -> List[tuple]:
    """Paths to every leaf of nested dicts and lists, dicts in key order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, prefix + (i,))]
    return [prefix]


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> List[Any]:
    return [tree_get(tree, p) for p in tree_paths(tree)]


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of the same structure (nested dicts
    and lists; dicts matched by key, so their key orders may differ)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def tree_to_numpy(tree):
    """A tree of tensors (or arrays) as f32 numpy copies."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32, copy=True).numpy()
        return np.array(x, np.float32)
    return tree_map(one, tree)


def tree_to_tensors(tree, device="cpu"):
    """A tree of numpy arrays (or tensors) as f32 tensors on ``device``,
    each a copy."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=device, dtype=torch.float32,
                                 copy=True)
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return tree_map(one, tree)


# ------------------------------------------------------------------ MLPs
def init_mlp(generator: torch.Generator, sizes: Sequence[int],
             scale: float = 1.0) -> List[Dict]:
    """He-normal weights (the last layer scaled by ``scale``) and zero
    biases, f32 on the generator's device, drawn layer by layer."""
    dev = generator.device
    layers = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        w_scale = (scale if last else 1.0) * np.sqrt(2.0 / fan_in)
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=dev)
        layers.append({"w": w * float(w_scale),
                       "b": torch.zeros((fan_out,), dtype=torch.float32,
                                        device=dev)})
    return layers


def mlp_forward(layers: List[Dict], x: torch.Tensor,
                activation=torch.tanh) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = activation(x)
    return x


def relu_mlp_forward(layers: List[Dict], x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP: the continuous-control nets (SAC/DDPG/TD3/CQL critics and
    actors) use ReLU, as the reference's torch models do."""
    return mlp_forward(layers, x, activation=torch.relu)


def init_actor_critic(generator: torch.Generator, obs_dim: int,
                      num_actions: int,
                      hiddens: Sequence[int] = (64, 64)) -> Dict:
    return {
        "pi": init_mlp(generator, [obs_dim, *hiddens, num_actions],
                       scale=0.01),
        "vf": init_mlp(generator, [obs_dim, *hiddens, 1], scale=1.0),
    }


def actor_critic_forward(params: Dict, obs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, A], value [B])."""
    logits = mlp_forward(params["pi"], obs)
    value = mlp_forward(params["vf"], obs)[..., 0]
    return logits, value


# ---------------------------------------------------------------- Box spaces
# Diagonal-Gaussian policies for continuous control (reference:
# ``rllib/models/torch/torch_distributions.py`` TorchDiagGaussian /
# TorchSquashedGaussian). One pi MLP emits [mean, log_std]; the squashed
# variants add the tanh log-det correction SAC's entropy term needs.

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0
_LOG_2PI = float(np.log(2.0 * np.pi))


def init_gaussian_actor_critic(generator: torch.Generator, obs_dim: int,
                               action_dim: int,
                               hiddens: Sequence[int] = (64, 64)) -> Dict:
    return {
        "pi": init_mlp(generator, [obs_dim, *hiddens, 2 * action_dim],
                       scale=0.01),
        "vf": init_mlp(generator, [obs_dim, *hiddens, 1], scale=1.0),
    }


def gaussian_actor_critic_forward(params: Dict, obs: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Returns (mean [B, A], log_std [B, A], value [B])."""
    out = mlp_forward(params["pi"], obs)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    value = mlp_forward(params["vf"], obs)[..., 0]
    return mean, log_std, value


def diag_gaussian_logp(mean: torch.Tensor, log_std: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Log-density of x under N(mean, diag(exp(log_std)^2)); sums the
    action axis -> [B]."""
    z = (x - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z ** 2 - log_std - 0.5 * _LOG_2PI, dim=-1)


def diag_gaussian_entropy(log_std: torch.Tensor) -> torch.Tensor:
    """Entropy of the diagonal Gaussian, summed over actions -> [B]."""
    return torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)


def tanh_logp_correction(pre_tanh: torch.Tensor) -> torch.Tensor:
    """log|det d tanh(u)/du| summed over the action axis -> [B], in the
    stable form log(1 - tanh(u)^2) = 2 * (log 2 - u - softplus(-2u))."""
    return torch.sum(
        2.0 * (float(np.log(2.0)) - pre_tanh
               - F.softplus(-2.0 * pre_tanh)), dim=-1)


def squashed_gaussian_sample(generator, mean: torch.Tensor,
                             log_std: torch.Tensor,
                             noise: torch.Tensor = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-squashed sample; returns (action in (-1, 1),
    log-prob [B] with the tanh correction applied). The standard normal
    ``noise`` is drawn from ``generator`` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
    u = mean + torch.exp(log_std) * noise
    logp = diag_gaussian_logp(mean, log_std, u) - tanh_logp_correction(u)
    return torch.tanh(u), logp
