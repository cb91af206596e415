"""Internal KV helpers (reference: ``python/ray/experimental/
internal_kv.py`` — thin module-level functions over the GCS KV table,
used by libraries for small control-plane metadata)."""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.core.global_state import global_worker


def _kv_initialized() -> bool:
    from ray_tpu_torch.core.global_state import try_global_worker
    return try_global_worker() is not None


def _internal_kv_put(key: bytes, value: bytes, overwrite: bool = True,
                     namespace: str = "") -> bool:
    """Returns True if the key already existed."""
    w = global_worker()
    if not overwrite and w.kv_exists(_b(key), ns=namespace):
        return True
    existed = w.kv_exists(_b(key), ns=namespace)
    w.kv_put(_b(key), _b(value), ns=namespace)
    return existed


def _internal_kv_get(key: bytes, namespace: str = "") -> Optional[bytes]:
    return global_worker().kv_get(_b(key), ns=namespace)


def _internal_kv_exists(key: bytes, namespace: str = "") -> bool:
    return global_worker().kv_exists(_b(key), ns=namespace)


def _internal_kv_del(key: bytes, namespace: str = "") -> bool:
    return global_worker().kv_del(_b(key), ns=namespace)


def _internal_kv_list(prefix: bytes, namespace: str = "") -> List[bytes]:
    return global_worker().kv_keys(_b(prefix), ns=namespace)


def _b(v) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)
