"""Rotary position embeddings (RoPE), as in ``ray_tpu/ops/rotary.py``.

Two layouts:
- ``"neox"`` (rotate-half): the first half of the rotated features is
  paired with the second half (GPT-NeoX, Llama).
- ``"gptj"`` (rotate-every-two): even/odd interleaved pairs (GPT-J).

Tables are f32 and the rotation is computed in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rotary_table(max_len: int, rot_dim: int, base: float = 10000.0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape (max_len, rot_dim // 2), f32."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.sin(freqs), torch.cos(freqs)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 layout: str = "gptj") -> torch.Tensor:
    """Apply RoPE to ``x`` of shape (..., seq, heads, head_dim).

    Only the leading ``2 * sin.shape[-1]`` features are rotated; the rest
    pass through. ``positions`` (..., seq) are absolute positions;
    ``None`` means ``arange(seq)``.
    """
    rot = 2 * sin.shape[-1]
    seq = x.shape[-3]
    if positions is None:
        sin_p = sin[:seq][:, None, :]
        cos_p = cos[:seq][:, None, :]
    else:
        idx = positions.long()
        sin_p = sin[idx][..., :, None, :]
        cos_p = cos[idx][..., :, None, :]

    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x32 = x_rot.float()
    if layout == "gptj":
        x1 = x32[..., 0::2]
        x2 = x32[..., 1::2]
        r1 = x1 * cos_p - x2 * sin_p
        r2 = x2 * cos_p + x1 * sin_p
        rotated = torch.stack([r1, r2], dim=-1).reshape(x32.shape)
    elif layout == "neox":
        half = rot // 2
        x1 = x32[..., :half]
        x2 = x32[..., half:]
        r1 = x1 * cos_p - x2 * sin_p
        r2 = x2 * cos_p + x1 * sin_p
        rotated = torch.cat([r1, r2], dim=-1)
    else:
        raise ValueError(f"unknown rotary layout: {layout!r}")
    rotated = rotated.to(x.dtype)
    if x_pass.shape[-1] == 0:
        return rotated
    return torch.cat([rotated, x_pass], dim=-1)
