"""Per-worker training session: the bridge between user ``train_func``
and the driver loop.

Reference: ``python/ray/train/_internal/session.py`` — ``_TrainSession``
:109 runs the user function on a thread; ``report`` (:402/:662) persists
the checkpoint and enqueues a result that the driver drains; the queue is
bounded so training paces with the driver. Context accessors mirror
``ray.train.get_context()`` (world_rank/world_size/local_rank/node_rank).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._internal.storage import StorageContext

_session: Optional["_TrainSession"] = None


@dataclass
class _TrainingResult:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    done: bool = False
    error: Optional[BaseException] = None


class _TrainSession:
    def __init__(self, train_func: Callable[[], Any], world_rank: int,
                 world_size: int, local_rank: int, local_world_size: int,
                 node_rank: int, storage: Optional[StorageContext],
                 checkpoint: Optional[Checkpoint],
                 experiment_name: str = "", trial_name: str = "",
                 trial_id: str = ""):
        self.train_func = train_func
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self.storage = storage
        self.loaded_checkpoint = checkpoint
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.trial_id = trial_id
        self.iteration = 0
        # Bounded: report() blocks until the driver consumed the previous
        # result, so workers stay in lockstep with the driver loop.
        self._queue: "queue.Queue[_TrainingResult]" = queue.Queue(maxsize=1)
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------
    def start(self) -> None:
        def runner():
            try:
                self.train_func()
                self._queue.put(_TrainingResult(metrics={}, done=True))
            except BaseException as e:  # surfaced at the driver
                self._queue.put(
                    _TrainingResult(metrics={}, done=True, error=e))

        self._thread = threading.Thread(
            target=runner, name="train_fn", daemon=True)
        self._thread.start()

    def get_next(self) -> _TrainingResult:
        return self._queue.get()

    # -- user API (called from inside train_func) ---------------------
    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self.iteration += 1
        persisted = None
        if checkpoint is not None:
            if self.storage is not None and self.world_rank == 0:
                persisted = self.storage.persist_current_checkpoint(checkpoint)
            else:
                persisted = checkpoint
        self._queue.put(_TrainingResult(metrics=metrics, checkpoint=persisted))


def init_session(**kwargs) -> _TrainSession:
    global _session
    _session = _TrainSession(**kwargs)
    return _session


def get_session() -> Optional[_TrainSession]:
    return _session


def shutdown_session() -> None:
    global _session
    _session = None


# ---------------------------------------------------------------------
# Public accessors (exported as ray_tpu_torch.train.report / get_context / ...)
# ---------------------------------------------------------------------

class TrainContext:
    """Reference: ``ray.train.get_context()`` context object."""

    def _s(self) -> _TrainSession:
        s = get_session()
        if s is None:
            raise RuntimeError(
                "No train session active: this API must be called inside a "
                "train_func launched by a Trainer.")
        return s

    def get_world_size(self) -> int:
        return self._s().world_size

    def get_world_rank(self) -> int:
        return self._s().world_rank

    def get_local_rank(self) -> int:
        return self._s().local_rank

    def get_local_world_size(self) -> int:
        return self._s().local_world_size

    def get_node_rank(self) -> int:
        return self._s().node_rank

    def get_experiment_name(self) -> str:
        return self._s().experiment_name

    def get_trial_name(self) -> str:
        return self._s().trial_name

    def get_trial_id(self) -> str:
        return self._s().trial_id

    def get_storage(self) -> Optional[StorageContext]:
        return self._s().storage


def get_context() -> TrainContext:
    return TrainContext()


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    s = get_session()
    if s is None:
        raise RuntimeError("ray_tpu_torch.train.report() outside a train session")
    s.report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    if s is None:
        return None
    return s.loaded_checkpoint


def get_dataset_shard(dataset_name: str = "train"):
    """Reference: ``ray.train.get_dataset_shard``. Returns the per-worker
    shard iterator attached by the trainer's DataConfig."""
    s = get_session()
    if s is None:
        return None
    shards = getattr(s, "dataset_shards", None) or {}
    return shards.get(dataset_name)
