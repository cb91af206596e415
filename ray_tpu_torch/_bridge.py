"""Carry weights between the JAX package's parameter trees and the port's.

Both trees have the same keys and the same stacked ``[n_layers, ...]``
layer leaves, and the bridge keeps them so. It takes numpy arrays (a
test converts JAX arrays with ``np.asarray``), so the port never imports
JAX. Matrices are cast to the compute dtype once: the JAX model keeps f32
masters and casts at each use (``.astype(dt)``), which gives the same
numbers. Norm scales and biases stay f32, as the JAX model reads them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

#: leaves read in f32 by the model (norm scales, biases)
F32_LEAVES = frozenset({"ln_scale", "ln_bias", "fc_in_b", "fc_out_b",
                        "attn_norm", "mlp_norm", "scale", "bias", "b"})


def params_from_jax(tree: Dict[str, Any], config, device) -> Dict[str, Any]:
    """Numpy parameter tree (JAX layout) -> tensors on ``device``:
    matrices in ``config.dtype``, norm scales and biases in f32."""
    dev = torch.device(device)

    def convert(name: str, value):
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)   # bf16 (ml_dtypes) and others
        dt = torch.float32 if name in F32_LEAVES else config.dtype
        return torch.tensor(arr).to(device=dev, dtype=dt)   # a copy

    return {k: convert(k, v) for k, v in tree.items()}


def to_numpy(tree):
    """Tensor tree (or tensor) -> numpy f32 arrays of the same tree."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()
