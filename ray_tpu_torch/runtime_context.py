"""Runtime context (reference: ``python/ray/runtime_context.py``)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.global_state import global_worker


class RuntimeContext:
    def __init__(self, worker):
        self._w = worker

    def get_job_id(self) -> str:
        return self._w.job_id.hex()

    def get_node_id(self) -> str:
        return self._w.node_id.hex()

    def get_worker_id(self) -> str:
        return self._w.worker_id.hex()

    def get_task_id(self) -> Optional[str]:
        return self._w.current_task_id.hex()

    def get_actor_id(self) -> Optional[str]:
        aid = getattr(self._w, "_current_actor_id", None)
        return aid.hex() if aid else None

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_actor_handle(self):
        from ray_tpu_torch.actor import ActorHandle
        aid = getattr(self._w, "_current_actor_id", None)
        if aid is None:
            raise RuntimeError("not running inside an actor")
        return ActorHandle(aid)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(global_worker())
