"""Learner-to-engine weight refresh over the int8 blockwise wire: the
port's copy of the codec of ``ray_tpu/rlhf/weight_sync.py``.

The wire format is :mod:`ray_tpu_torch.parallel.quantization`'s (values
int8 ``[nblocks, block_size]`` and f32 per-block scales): each float
leaf of the parameter tree ships about 4x smaller than f32. Non-float
leaves ship verbatim. The payload is pure numpy, the same bytes as the
JAX package's for the same numpy input, so either package reads the
other's. A torch tensor leaf is read as its f32 numpy copy (numpy has
no bfloat16 of its own).

The refresh is version-stamped at the source: ``pack_weights`` bakes
the policy version into the payload, and the engine stamps every token
it emits after the swap with it. Dequantization runs on the caller's
thread (the actor call that delivers the payload), never on the
engine's step thread.

The publisher, the rollout engine and the trainer of the JAX package's
``rlhf/`` are still to be ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.parallel.quantization import (DEFAULT_BLOCK_SIZE,
                                                 dequantize_int8_np,
                                                 quantize_int8_np)

_SEP = "/"


def _flatten(tree: Dict[str, Any], prefix: str = ""
             ) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, key))
        else:
            out.append((key, v))
    return out


def _unflatten(entries: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, v in entries.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return np.asarray(leaf)


def _np_dtype(name: str) -> np.dtype:
    """The leaf's numpy dtype; f32 for a name numpy does not know here
    (``bfloat16`` from the JAX package without ``ml_dtypes`` loaded)."""
    try:
        return np.dtype(name)
    except TypeError:
        return np.dtype(np.float32)


def pack_weights(params: Dict[str, Any], version: int,
                 block_size: int = DEFAULT_BLOCK_SIZE
                 ) -> Dict[str, Any]:
    """Quantize a (nested-dict) parameter tree to the int8 wire payload.
    Float leaves become ``{"q", "scales", "shape", "dtype"}``; integer
    and boolean leaves ship raw. The payload is pure numpy: it crosses
    the object store through the out-of-band serializer."""
    entries: Dict[str, Dict[str, Any]] = {}
    for key, leaf in _flatten(params):
        arr = _as_numpy(leaf)
        if arr.dtype.kind == "f":
            q, scales = quantize_int8_np(arr, block_size)
            entries[key] = {"q": q, "scales": scales,
                            "shape": arr.shape, "dtype": str(arr.dtype)}
        else:
            entries[key] = {"raw": arr}
    return {"version": int(version), "block_size": int(block_size),
            "entries": entries}


def unpack_weights(packed: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], int]:
    """Invert :func:`pack_weights` -> ``(params, version)``, numpy
    leaves."""
    out: Dict[str, Any] = {}
    for key, e in packed["entries"].items():
        if "raw" in e:
            out[key] = e["raw"]
        else:
            out[key] = dequantize_int8_np(
                e["q"], e["scales"], shape=e["shape"],
                dtype=_np_dtype(e["dtype"]))
    return _unflatten(out), int(packed["version"])


def packed_wire_bytes(packed: Dict[str, Any]) -> int:
    """Payload bytes of one refresh (int8 values, f32 scales and raw
    leaves)."""
    total = 0
    for e in packed["entries"].values():
        if "raw" in e:
            total += e["raw"].nbytes
        else:
            total += e["q"].nbytes + e["scales"].nbytes
    return total
