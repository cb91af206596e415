"""joblib backend: run scikit-learn/joblib Parallel work as ray tasks.

Reference: ``python/ray/util/joblib/`` — ``register_ray()`` installs a
joblib ParallelBackend whose ``apply_async`` submits batches to the
cluster, so ``with joblib.parallel_backend("ray_tpu_torch"): Parallel(...)``
fans out across workers with no scikit-learn changes. The port's copy
of ``ray_tpu/util/joblib_backend.py``: the backend's name is
``"ray_tpu_torch"``.
"""

from __future__ import annotations

from typing import Any

__all__ = ["register_ray"]


def register_ray() -> None:
    """Register the ``"ray_tpu_torch"`` joblib backend (reference:
    ``ray.util.joblib.register_ray``)."""
    from joblib.parallel import ParallelBackendBase, register_parallel_backend

    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _run_batch(batch):
        return batch()

    class _RayTpuBackend(ParallelBackendBase):
        supports_timeout = True
        #: joblib uses this to size batches; cluster CPU count is the
        #: honest parallelism bound
        def effective_n_jobs(self, n_jobs: int) -> int:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(ignore_reinit_error=True)
            cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            if n_jobs == -1 or n_jobs is None:
                return max(1, cpus)
            return max(1, min(n_jobs, cpus))

        def configure(self, n_jobs: int = 1, parallel=None,
                      **backend_args: Any) -> int:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init(ignore_reinit_error=True)
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def apply_async(self, func, callback=None):
            ref = _run_batch.remote(func)
            return _RayFuture(ref, callback)

        def abort_everything(self, ensure_ready: bool = True) -> None:
            pass  # refs are dropped; tasks finish or are GC'd

    class _RayFuture:
        def __init__(self, ref, callback):
            self._ref = ref
            self._callback = callback
            self._done = False
            self._value = None

        def get(self, timeout: float = None):
            if not self._done:
                self._value = ray_tpu_torch.get(self._ref, timeout=timeout)
                self._done = True
                if self._callback is not None:
                    self._callback(self._value)
            return self._value

    register_parallel_backend("ray_tpu_torch", _RayTpuBackend)
