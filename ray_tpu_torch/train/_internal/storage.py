"""StorageContext: where a run's checkpoints and artifacts live.

Reference: ``python/ray/train/_internal/storage.py:349`` —
``StorageContext`` resolves ``RunConfig.storage_path`` into per-experiment
and per-trial directories and persists checkpoints
(``persist_current_checkpoint`` :522). This build keeps the same layout
(``{storage_path}/{experiment_name}/{trial_dir}/checkpoint_NNNNNN``) on a
local or shared filesystem (a network mount appears as a local path, so
one code path covers both).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train._checkpoint import Checkpoint


class StorageContext:
    def __init__(self, storage_path: str, experiment_name: str,
                 trial_dir_name: Optional[str] = None):
        self.storage_path = os.path.abspath(os.path.expanduser(storage_path))
        self.experiment_name = experiment_name
        self.trial_dir_name = trial_dir_name
        os.makedirs(self.experiment_dir, exist_ok=True)
        # Resume numbering past any checkpoints already on disk so a
        # restored/restarted run never overwrites earlier directories.
        existing = self.list_checkpoints()
        self.current_checkpoint_index = (
            int(os.path.basename(existing[-1]).split("_")[-1]) + 1
            if existing else 0)

    @property
    def experiment_dir(self) -> str:
        return os.path.join(self.storage_path, self.experiment_name)

    @property
    def trial_dir(self) -> str:
        if self.trial_dir_name is None:
            return self.experiment_dir
        d = os.path.join(self.experiment_dir, self.trial_dir_name)
        os.makedirs(d, exist_ok=True)
        return d

    def checkpoint_dir(self, index: int) -> str:
        return os.path.join(self.trial_dir, f"checkpoint_{index:06d}")

    def persist_current_checkpoint(self, checkpoint: Checkpoint) -> Checkpoint:
        """Copy a (worker-local) checkpoint into run storage.

        Reference ``storage.py:522``. Returns the persisted checkpoint.
        """
        dest = self.checkpoint_dir(self.current_checkpoint_index)
        self.current_checkpoint_index += 1
        if os.path.abspath(checkpoint.path) == dest:
            return checkpoint
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
        return Checkpoint(dest)

    def list_checkpoints(self) -> List[str]:
        if not os.path.isdir(self.trial_dir):
            return []
        return sorted(
            os.path.join(self.trial_dir, d)
            for d in os.listdir(self.trial_dir)
            if d.startswith("checkpoint_"))


class CheckpointManager:
    """Top-K retention over persisted checkpoints.

    Reference: ``python/ray/train/_internal/checkpoint_manager.py`` driven
    by ``CheckpointConfig`` (``air/config.py:425``).
    """

    def __init__(self, storage: StorageContext, num_to_keep: Optional[int],
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.storage = storage
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        # (checkpoint, metrics) newest-last
        self._tracked: List[Tuple[Checkpoint, Dict[str, Any]]] = []

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return self._tracked[-1][0] if self._tracked else None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        if not self.score_attribute:
            return self._tracked[-1][0]
        scored = [t for t in self._tracked
                  if self.score_attribute in (t[1] or {})]
        if not scored:
            return self._tracked[-1][0]
        key = lambda t: t[1][self.score_attribute]  # noqa: E731
        return (max if self.score_order == "max" else min)(scored, key=key)[0]

    @property
    def checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        return list(self._tracked)

    def register_checkpoint(self, checkpoint: Checkpoint,
                            metrics: Optional[Dict[str, Any]] = None) -> None:
        self._tracked.append((checkpoint, metrics or {}))
        self._enforce_retention()

    def _enforce_retention(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self._tracked) > self.num_to_keep:
            # Evict the worst-scored (or oldest) checkpoint, never the latest.
            candidates = self._tracked[:-1]
            if self.score_attribute:
                key = lambda t: t[1].get(  # noqa: E731
                    self.score_attribute,
                    float("-inf") if self.score_order == "max"
                    else float("inf"))
                evict = (min if self.score_order == "max" else max)(
                    candidates, key=key)
            else:
                evict = candidates[0]
            self._tracked.remove(evict)
            shutil.rmtree(evict[0].path, ignore_errors=True)
