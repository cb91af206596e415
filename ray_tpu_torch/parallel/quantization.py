"""Int8 blockwise quantization: the port's copy of the wire format of
``ray_tpu/parallel/quantization.py``.

A tensor is flattened, zero-padded to a whole number of ``block_size``
element blocks, and each block is quantized symmetrically to int8
against its own f32 scale ``amax / 127`` (1 for an all-zero block, so
padding never perturbs a scale), rounding half to even. On the wire a
block costs ``block_size`` bytes plus 4 bytes of scale.

:func:`quantize_int8` / :func:`dequantize_int8` work on torch tensors on
any device, so a CUDA slab is quantized on the card before its one copy
to the host; they give the same int8 values and scales, byte for byte,
as the numpy twins :func:`quantize_int8_np` / :func:`dequantize_int8_np`
(the same f32 division and the same rounding). Stochastic rounding and
the collective helpers wait for the port's sharding slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_BLOCK_SIZE = 256
_QMAX = 127.0


def _padded_len(n: int, block_size: int) -> int:
    return -(-n // block_size) * block_size


def wire_bytes(numel: int, block_size: int = DEFAULT_BLOCK_SIZE,
               transport: str = "int8") -> int:
    """Bytes one ``numel`` tensor costs on the wire: ``4 * numel`` for
    f32 transport; for int8 one byte a padded element plus a 4-byte f32
    scale a block."""
    if transport == "fp32":
        return 4 * numel
    nblocks = -(-numel // block_size)
    return nblocks * block_size + 4 * nblocks


def quantize_int8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (any shape, dtype and device) -> ``(values int8 [nblocks,
    block_size], scales f32 [nblocks])`` on ``x``'s device, blocks taken
    over the row-major flattening of ``x``."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    flat = F.pad(flat, (0, _padded_len(n, block_size) - n))
    blocks = flat.view(-1, block_size)
    amax = blocks.abs().amax(dim=1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, 1 ulp off the f32 quotient
    # numpy computes
    scales = torch.where(amax > 0, amax / torch.full_like(amax, _QMAX),
                         torch.ones_like(amax))
    q = torch.round(blocks / scales[:, None]).clamp_(-_QMAX, _QMAX)
    return q.to(torch.int8), scales


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor, shape=None,
                    dtype=None) -> torch.Tensor:
    """Invert :func:`quantize_int8`. ``shape=None`` returns the padded
    1-D f32 payload; otherwise the result is cut to ``shape`` (and cast
    to ``dtype`` if given)."""
    flat = (values.to(torch.float32) * scales[..., None]).reshape(-1)
    if shape is not None:
        size = int(np.prod(shape)) if shape else 1
        flat = flat[:size].reshape(tuple(shape))
    return flat.to(dtype) if dtype is not None else flat


# ------------------------------------------------- NumPy reference twins
def quantize_int8_np(x: np.ndarray, block_size: int = DEFAULT_BLOCK_SIZE
                     ) -> Tuple[np.ndarray, np.ndarray]:
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    n = flat.shape[0]
    flat = np.pad(flat, (0, _padded_len(n, block_size) - n))
    blocks = flat.reshape(-1, block_size)
    amax = np.max(np.abs(blocks), axis=1)
    scales = np.where(amax > 0, amax / _QMAX, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / scales[:, None]), -_QMAX, _QMAX)
    return q.astype(np.int8), scales


def dequantize_int8_np(values: np.ndarray, scales: np.ndarray,
                       shape=None, dtype=None) -> np.ndarray:
    flat = (values.astype(np.float32) * scales[..., None]).reshape(-1)
    if shape is not None:
        size = int(np.prod(shape)) if shape else 1
        flat = flat[:size].reshape(shape)
    return flat.astype(dtype) if dtype is not None else flat
