"""Process-global worker/runtime handle (reference:
``python/ray/_private/worker.py`` module-level ``global_worker``)."""

from __future__ import annotations

from typing import Optional

_worker = None


def set_global_worker(worker) -> None:
    global _worker
    _worker = worker


def try_global_worker():
    return _worker


def global_worker():
    if _worker is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first.")
    return _worker
