"""Backend interface: per-framework worker-group setup, the port of
``ray_tpu/train/backend.py``.

Reference: ``python/ray/train/backend.py`` — ``BackendConfig`` +
``Backend`` with ``on_start``/``on_training_start``/``on_shutdown`` hooks
(the Torch backend uses these to run ``dist.init_process_group``,
``train/torch/config.py:146``, as the port's ``train/torch/config.py``
does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Type

if TYPE_CHECKING:
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup


@dataclass
class BackendConfig:
    @property
    def backend_cls(self) -> Type["Backend"]:
        return Backend


class Backend:
    """No-op base backend."""

    share_cuda_visible_devices: bool = False  # reference parity; unused

    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: "WorkerGroup",
                          backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: BackendConfig) -> None:
        pass
