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
(the same f32 division and the same rounding).

Rounding is round-half-to-even by default; ``stochastic_rounding=True``
makes the quantizer unbiased (``E[dequant(quant(x))] = x``), drawing its
uniforms from an explicit ``torch.Generator`` (the JAX package draws
them from a PRNG key, so the two packages' stochastic bits differ).
:func:`fake_quant` is one wire leg's error, :func:`compression_ratio`
and :func:`tree_wire_bytes` the wire's size.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def compression_ratio(numel: int,
                      block_size: int = DEFAULT_BLOCK_SIZE) -> float:
    """f32 bytes over int8-wire bytes for a ``numel`` tensor: payload is
    1 byte/elem (after padding) + 4 bytes of scale per block."""
    nblocks = -(-numel // block_size)
    return (4.0 * numel) / (nblocks * block_size + 4.0 * nblocks)


def tree_wire_bytes(shapes, block_size: int = DEFAULT_BLOCK_SIZE,
                    transport: str = "int8") -> int:
    """Sum of :func:`wire_bytes` over an iterable of shapes (or sizes):
    the per-step gradient wire budget of one rank."""
    total = 0
    for s in shapes:
        numel = int(s) if np.isscalar(s) else int(np.prod(s)) if s else 1
        total += wire_bytes(numel, block_size, transport)
    return total


def quantize_int8(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE,
                  stochastic_rounding: bool = False,
                  generator: Optional[torch.Generator] = None,
                  jitted_scales: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` (any shape, dtype and device) -> ``(values int8 [nblocks,
    block_size], scales f32 [nblocks])`` on ``x``'s device, blocks taken
    over the row-major flattening of ``x``. ``stochastic_rounding``
    rounds ``floor(x / scale + u)``, ``u ~ U[0, 1)`` from ``generator``
    (required, on ``x``'s device). ``jitted_scales`` computes each scale
    as ``amax * float32(1 / 127)``: XLA rewrites the JAX function's
    division by the constant 127 into that product under ``jit``, so the
    JAX package's jitted collectives carry those scales (1 ulp off the
    quotient the numpy twin and the KV wire codec compute)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    flat = F.pad(flat, (0, _padded_len(n, block_size) - n))
    blocks = flat.view(-1, block_size)
    amax = blocks.abs().amax(dim=1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, 1 ulp off the f32 quotient
    # numpy computes
    if jitted_scales:
        scaled_max = amax * torch.full_like(amax, np.float32(1.0 / _QMAX))
    else:
        scaled_max = amax / torch.full_like(amax, _QMAX)
    scales = torch.where(amax > 0, scaled_max, torch.ones_like(amax))
    scaled = blocks / scales[:, None]
    if stochastic_rounding:
        if generator is None:
            raise ValueError("stochastic_rounding requires a generator")
        q = torch.floor(scaled + torch.rand(
            scaled.shape, generator=generator, device=scaled.device))
    else:
        q = torch.round(scaled)
    return q.clamp_(-_QMAX, _QMAX).to(torch.int8), scales


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


def fake_quant(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE,
               stochastic_rounding: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``dequant(quant(x))`` in ``x``'s shape and dtype: the error a tensor
    picks up crossing one quantized wire leg."""
    q, s = quantize_int8(x, block_size, stochastic_rounding, generator)
    return dequantize_int8(q, s, x.shape, x.dtype)


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
