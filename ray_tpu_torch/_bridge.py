"""Carry weights between the JAX package's parameter trees and the port's.

Both trees have the same keys and the same stacked ``[n_layers, ...]``
layer leaves, and the bridge keeps them so. It takes numpy arrays (a
test converts JAX arrays with ``np.asarray``), so the port never imports
JAX. For serving, matrices are cast to the compute dtype once: the JAX
model keeps f32 masters and casts at each use (``.astype(dt)``), which
gives the same numbers. For training (``masters=True``) every leaf stays
f32, as the JAX trainer holds it. Norm scales and biases stay f32 either
way. :func:`train_state_from_jax` carries a whole JAX train state (params
and the optax ``clip -> adamw`` moments) into the port's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

#: leaves read in f32 by the model (norm scales, biases)
F32_LEAVES = frozenset({"ln_scale", "ln_bias", "fc_in_b", "fc_out_b",
                        "attn_norm", "mlp_norm", "scale", "bias", "b"})


def params_from_jax(tree: Dict[str, Any], config, device,
                    masters: bool = False) -> Dict[str, Any]:
    """Numpy parameter tree (JAX layout) -> tensors on ``device``:
    matrices in ``config.dtype`` (f32 with ``masters=True``), norm scales
    and biases in f32."""
    dev = torch.device(device)

    def convert(name: str, value):
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)   # bf16 (ml_dtypes) and others
        dt = torch.float32 if masters or name in F32_LEAVES \
            else config.dtype
        return torch.tensor(arr).to(device=dev, dtype=dt)   # a copy

    return {k: convert(k, v) for k, v in tree.items()}


def to_numpy(tree):
    """Tensor tree (or tensor) -> numpy f32 arrays of the same tree."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()


def _find_adam_state(opt_state):
    """The optax ``ScaleByAdamState`` (the node with ``count``, ``mu`` and
    ``nu``) inside a numpy-converted optax state of nested tuples."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _find_adam_state(item)
            if found is not None:
                return found
    return None


def train_state_from_jax(state: Dict[str, Any], config,
                         device) -> Dict[str, Any]:
    """A JAX train state (``{"params", "opt_state", "step"}`` with an optax
    ``clip_by_global_norm -> adamw`` state, leaves as numpy arrays) ->
    the port's train state: f32 params, ``{"count", "mu", "nu"}`` and
    ``step`` on ``device``, so a run resumes where the JAX one stopped."""
    dev = torch.device(device)
    adam = _find_adam_state(state["opt_state"])
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in the opt_state")
    return {
        "params": params_from_jax(state["params"], config, dev, masters=True),
        "opt_state": {
            "count": torch.tensor(int(np.asarray(adam.count)),
                                  dtype=torch.int32, device=dev),
            "mu": params_from_jax(adam.mu, config, dev, masters=True),
            "nu": params_from_jax(adam.nu, config, dev, masters=True)},
        "step": torch.tensor(int(np.asarray(state["step"])),
                             dtype=torch.int32, device=dev)}
