"""Normalization ops. Statistics are computed in float32 whatever the
activation dtype, and the result is cast back to x's dtype (or
``dtype``), as in ``ray_tpu/ops/norms.py``."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RMSNorm over the last axis; ``scale`` broadcasts on it."""
    out_dtype = dtype or x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float()).to(out_dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis with learned scale and bias."""
    out_dtype = dtype or x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * scale.float() + bias.float()
    return y.to(out_dtype)
