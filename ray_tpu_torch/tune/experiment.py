"""Trial: one (config, trainable) run tracked by the controller.

Reference: ``python/ray/tune/experiment/trial.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.train._checkpoint import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any],
                 experiment_name: str = ""):
        self.trial_id = trial_id
        self.config = config
        self.experiment_name = experiment_name
        self.status = PENDING
        self.last_result: Dict[str, Any] = {}
        self.results: list = []
        self.checkpoint: Optional[Checkpoint] = None
        self.error: Optional[BaseException] = None
        self.actor = None
        self.iteration = 0
        self.restore_pending: Optional[Checkpoint] = None

    @property
    def trial_name(self) -> str:
        return f"{self.trial_id}"

    def metric_value(self, metric: str) -> Optional[float]:
        v = self.last_result.get(metric)
        return float(v) if v is not None else None

    def __repr__(self):
        return (f"Trial({self.trial_id}, status={self.status}, "
                f"iter={self.iteration})")
