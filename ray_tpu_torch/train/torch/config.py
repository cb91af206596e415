"""The torch backend: a ``torch.distributed`` process group over the
worker gang, the counterpart of ``ray_tpu/train/jax/config.py``.

Reference shape: ``python/ray/train/torch/config.py:146`` —
``_TorchBackend.on_start`` picks a rendezvous address on rank 0 and runs
``dist.init_process_group`` on every worker. Here every worker calls
``parallel/collective.py::init_torch_distributed`` (rank 0 opens a
``TCPStore`` and publishes its address in the runtime's KV) under a group
name of its own for each start and each restart, so a restarted gang
never reads the address of the one it replaces. A ``train_func`` then
builds its mesh over the default group (``parallel.mesh.build_mesh``).

``backend=None`` picks ``nccl`` where each worker holds a whole card and
``gloo`` otherwise (on the CPU, or where ranks share a card: NCCL
refuses two ranks on one device), the rule of
``parallel/mpmd_pipeline.py::_join_stage_groups``. One worker forms no
group.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Optional, Type

from ray_tpu_torch.train.backend import Backend, BackendConfig


@dataclass
class TorchConfig(BackendConfig):
    #: "nccl", "gloo", or None to pick by the workers' devices
    backend: Optional[str] = None

    @property
    def backend_cls(self) -> Type["_TorchBackend"]:
        return _TorchBackend


def _pick_backend(gpus_per_worker: float) -> str:
    return "nccl" if gpus_per_worker == 1.0 else "gloo"


def _setup_torch_process_group(group_name: str, backend: str,
                               world_size: int, rank: int) -> None:
    """Runs on each worker before ``train_func``."""
    from ray_tpu_torch.parallel.collective import init_torch_distributed
    init_torch_distributed(group_name, backend=backend,
                           num_processes=world_size, process_id=rank)


def _shutdown_torch_process_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        import ray_tpu_torch
        worker_group.fetch_metadata()  # refresh even if previously set
        worker_group.sort_workers_by_node()
        n = len(worker_group)
        if n == 1:
            return
        backend = backend_config.backend or _pick_backend(
            worker_group.gpus_per_worker)
        name = f"train-{uuid.uuid4().hex[:12]}"
        ray_tpu_torch.get([
            w.execute.remote(_setup_torch_process_group, name, backend, n,
                             rank)
            for rank, w in enumerate(worker_group.workers)])

    def on_shutdown(self, worker_group, backend_config: TorchConfig) -> None:
        if worker_group.workers:
            try:
                worker_group.execute(_shutdown_torch_process_group)
            except Exception:
                pass
