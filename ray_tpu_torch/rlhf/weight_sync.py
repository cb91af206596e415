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
thread (the actor call that delivers the payload, or the publisher's),
never on the engine's step thread.

:class:`WeightPublisher` fans a refresh out to in-process engines
(``stage_weights``, after a dequantization on its device into each
engine's dtypes) and to remote handles (``sync_weights``, which ship the
packed payload).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch._bridge import params_from_jax
from ray_tpu_torch.exceptions import EngineDeadError
from ray_tpu_torch.parallel.quantization import (DEFAULT_BLOCK_SIZE,
                                                 dequantize_int8,
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


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of :func:`_np_dtype`'s answer."""
    dt = _np_dtype(name).name
    return getattr(torch, dt) if dt in ("bfloat16", "float16", "float32",
                                        "float64") else torch.float32


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


def unpack_weights(packed: Dict[str, Any], device=None
                   ) -> Tuple[Dict[str, Any], int]:
    """Invert :func:`pack_weights` -> ``(params, version)``, numpy
    leaves; with ``device``, the float leaves are dequantized there into
    torch tensors (the numpy twin's values: one f32 product each) and
    only the int8 values and scales cross to it."""
    out: Dict[str, Any] = {}
    for key, e in packed["entries"].items():
        if "raw" in e:
            out[key] = e["raw"]
        elif device is not None:
            out[key] = dequantize_int8(
                torch.from_numpy(e["q"]).to(device),
                torch.from_numpy(e["scales"]).to(device), shape=e["shape"],
                dtype=_torch_dtype(e["dtype"]))
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


def _f32_bytes(packed: Dict[str, Any]) -> int:
    """Bytes the payload's leaves would take in f32 (raw leaves as
    shipped): the denominator of the wire's compression."""
    total = 0
    for e in packed["entries"].values():
        if "raw" in e:
            total += e["raw"].nbytes
        else:
            total += 4 * int(np.prod(e["shape"])) if e["shape"] else 4
    return total


def await_version(engine, version: int, timeout_s: float = 60.0) -> None:
    """Wait until ``engine`` (an in-process ``LLMEngine``) has swapped in
    ``version`` or a newer one: its step thread swaps a staged tree at
    its next step boundary."""
    deadline = time.monotonic() + timeout_s
    while engine.stats()["weight_version"] < version:
        if engine._dead is not None:
            raise EngineDeadError(
                f"engine step loop died: {engine._dead!r}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"weight swap to version {version} never "
                               f"landed")
        time.sleep(0.002)


class WeightPublisher:
    """Monotone-versioned weight fan-out to a set of engines.

    Targets may be in-process :class:`~ray_tpu_torch.serve.llm_engine.
    LLMEngine` objects (``stage_weights``: the payload is dequantized
    HERE, on the publisher's thread, and carried into the engine's
    dtypes on its device; engines that share a device and a model
    config share one staged tree; a target with no ``model_config``
    takes the numpy tree) or remote handles exposing
    ``sync_weights`` (the packed payload ships; the replica dequantizes
    on its own actor thread). Either way the engine's step thread only
    swaps a pointer. ``publish`` returns once every in-process engine has
    swapped the new version in (at most one engine step later; decode
    never waits), so every token emitted after it returns carries that
    version or a newer one, and each publish is one swap: publishes that
    a step thread would otherwise see staged together no longer coalesce
    into one swap (the JAX publisher returns at staging: ROADMAP
    Queue 3). ``stats()`` also keeps the host seconds spent in
    :func:`pack_weights` and :func:`unpack_weights`.
    """

    def __init__(self, engines: List[Any],
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 recorder=None):
        self._engines = list(engines)
        self._block_size = block_size
        self._recorder = recorder
        self._lock = threading.Lock()
        self._version = 0
        self._publishes = 0
        self._wire_bytes = 0
        self._f32_bytes = 0
        self._publish_wall_s = 0.0
        self._pack_wall_s = 0.0
        self._unpack_wall_s = 0.0

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def publish(self, params: Dict[str, Any]) -> int:
        """Pack and fan out one refresh; returns the new version."""
        t0 = time.monotonic()
        with self._lock:
            self._version += 1
            version = self._version
        packed = pack_weights(params, version, self._block_size)
        t_pack = time.monotonic() - t0
        unpacked, t_unpack = None, 0.0
        staged: Dict[Any, Dict[str, Any]] = {}
        swapping = []
        for eng in self._engines:
            if hasattr(eng, "stage_weights"):
                cfg = getattr(eng, "model_config", None)
                if cfg is None:     # a target that takes the numpy tree
                    if unpacked is None:
                        t1 = time.monotonic()
                        unpacked, _ = unpack_weights(packed)
                        t_unpack += time.monotonic() - t1
                    eng.stage_weights(unpacked, version)
                    continue
                key = (str(eng.device), cfg)
                if key not in staged:
                    t1 = time.monotonic()
                    staged[key] = params_from_jax(unpack_weights(
                        packed, eng.device)[0], cfg, eng.device)
                    t_unpack += time.monotonic() - t1
                eng.stage_weights(staged[key], version)
                swapping.append(eng)
            else:
                eng.sync_weights(packed)
        for eng in swapping:
            await_version(eng, version)
        wall = time.monotonic() - t0
        with self._lock:
            self._publishes += 1
            self._wire_bytes += packed_wire_bytes(packed)
            self._f32_bytes += _f32_bytes(packed)
            self._publish_wall_s += wall
            self._pack_wall_s += t_pack
            self._unpack_wall_s += t_unpack
        return version

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "version": self._version,
                "publishes": self._publishes,
                "wire_bytes_total": self._wire_bytes,
                "f32_bytes_total": self._f32_bytes,
                "compression": (round(self._f32_bytes
                                      / self._wire_bytes, 3)
                                if self._wire_bytes else None),
                "publish_wall_s": round(self._publish_wall_s, 4),
                "pack_wall_s": round(self._pack_wall_s, 4),
                "unpack_wall_s": round(self._unpack_wall_s, 4),
            }
