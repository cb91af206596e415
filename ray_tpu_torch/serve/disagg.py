"""The KV wire codec of disaggregated prefill/decode: the port's copy of
the codec part of ``ray_tpu/serve/disagg.py``.

A prefill engine packs a request's finished KV blocks (``LLMEngine.
prefill_export``) and a decode engine adopts them into its own block
pool (``LLMEngine.submit_adopt``). Slabs are ``[n_layers, n_blocks,
block_size, kv_heads, head_dim]`` and the payload keeps the JAX
package's keys (``wire``, ``shape``, ``dtype``, ``k``, ``v``, and
``k_scales`` / ``v_scales`` on the int8 wire, ``wire_bytes``), so a
payload made by either package is adopted by the other.

Wire formats (``EngineConfig.kv_wire``):

- ``"bf16"``: the cache's own dtype shipped raw, bit-exact (an f32 cache
  ships f32). numpy has no bfloat16 of its own: a bf16 slab travels as
  its 16-bit pattern, in numpy's ``bfloat16`` dtype when an extension has
  registered one in this process (``ml_dtypes`` does, with JAX loaded, so
  the JAX package reads it unchanged), else as ``int16``; unpacking reads
  either through the bit pattern. The port imports no ``ml_dtypes``.
- ``"int8"``: blockwise symmetric int8 over 256-element blocks with one
  f32 scale each (:mod:`ray_tpu_torch.parallel.quantization`), quantized
  where the slab lives (on the card for a CUDA slab) before its one copy
  to the host, and dequantized on the adopting device.

The router, ``deploy_disaggregated`` and warm-prefix migration between
replicas ride the distributed runtime, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.parallel.quantization import (dequantize_int8,
                                                 quantize_int8, wire_bytes)

WIRES = ("bf16", "int8")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class DisaggHandoffError(RayTpuError):
    """The prefill->decode KV hand-off failed terminally, so callers can
    tell a hand-off failure from an in-decode failure."""


def _numpy_bf16() -> Optional[np.dtype]:
    """numpy's ``bfloat16`` dtype if an extension registered one in this
    process, else None."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return None


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 as its bit pattern (see the module
    docstring)."""
    t = t.detach().contiguous().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    bf16 = _numpy_bf16()
    return bits.view(bf16) if bf16 is not None else bits


def _to_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A numpy slab of the payload -> a CPU tensor of ``dtype`` with the
    same bits (bf16) or the same values."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
            and a.dtype.kind != "f":
        # the 16-bit pattern: int16/uint16, or an extension's bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def pack_kv_blocks(k: torch.Tensor, v: torch.Tensor,
                   wire: str = "bf16") -> Dict[str, Any]:
    """Pack gathered KV slabs ``[n_layers, n_blocks, block_size,
    kv_heads, head_dim]`` (tensors on any device) for the wire.
    ``"bf16"`` ships them in their own dtype, bit-exact; ``"int8"``
    quantizes each slab blockwise where it lives. Each array is copied to
    the host once. ``wire_bytes`` is the bytes of the arrays shipped."""
    if wire not in WIRES:
        raise ValueError(f"unknown kv wire format {wire!r}")
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if k.dtype != v.dtype:
        raise ValueError(f"k/v dtype mismatch: {k.dtype} vs {v.dtype}")
    dtype = str(k.dtype).split(".")[-1]
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"no kv wire for dtype {k.dtype}")
    out: Dict[str, Any] = {"wire": wire, "shape": list(k.shape),
                           "dtype": dtype}
    if wire == "bf16":
        out["k"], out["v"] = _to_numpy(k), _to_numpy(v)
        arrays = [out["k"], out["v"]]
    else:
        kq, ks = quantize_int8(k)
        vq, vs = quantize_int8(v)
        out["k"], out["k_scales"] = _to_numpy(kq), _to_numpy(ks)
        out["v"], out["v_scales"] = _to_numpy(vq), _to_numpy(vs)
        arrays = [out["k"], out["k_scales"], out["v"], out["v_scales"]]
    out["wire_bytes"] = int(sum(a.nbytes for a in arrays))
    return out


def unpack_kv_blocks(kv: Dict[str, Any], dtype: Optional[torch.dtype] = None,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert :func:`pack_kv_blocks`: ``(k, v)`` tensors ``[n_layers,
    n_blocks, block_size, kv_heads, head_dim]`` on ``device`` (default
    the CPU) in ``dtype`` (default: the dtype they were packed from).
    Each array goes to the device once; int8 is dequantized there."""
    shape = tuple(int(s) for s in kv["shape"])
    src = _TORCH_DTYPES.get(str(kv.get("dtype")))
    if src is None:
        raise ValueError(f"no kv wire for dtype {kv.get('dtype')!r}")
    tgt = dtype if dtype is not None else src
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if kv["wire"] == "bf16":
        k, v = (_to_tensor(kv[n], src).to(dev).to(tgt) for n in ("k", "v"))
    elif kv["wire"] == "int8":
        k, v = (dequantize_int8(torch.from_numpy(np.asarray(kv[n])).to(dev),
                                torch.from_numpy(
                                    np.asarray(kv[n + "_scales"])).to(dev),
                                shape=shape, dtype=tgt)
                for n in ("k", "v"))
    else:
        raise ValueError(f"unknown kv wire format {kv['wire']!r}")
    if tuple(k.shape) != shape:
        raise ValueError(
            f"unpacked shape {tuple(k.shape)} != packed shape {shape}")
    return k, v


def kv_ship_bytes(n_blocks: int, block_size: int, kv_heads: int,
                  head_dim: int, n_layers: int, wire: str = "bf16",
                  dtype_bytes: int = 2) -> int:
    """Wire footprint of one hand-off: ``2 (k+v) * n_layers * n_blocks *
    block_size * kv_heads * head_dim`` elements at ``dtype_bytes`` each
    for ``"bf16"``, or one byte an element plus one f32 scale a
    256-element block, k and v quantized apart, for ``"int8"``. Equal to
    the ``wire_bytes`` a packed payload reports."""
    numel = 2 * n_layers * n_blocks * block_size * kv_heads * head_dim
    if wire == "bf16":
        return numel * dtype_bytes
    return 2 * wire_bytes(numel // 2, transport="int8")
