"""Result: the outcome of one training/tuning run.

Reference: ``python/ray/air/result.py`` (re-exported as
``ray.train.Result``) — final metrics, best/latest checkpoint, error,
and the run's storage path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train._checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: List[Tuple[Checkpoint, Dict[str, Any]]] = field(
        default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")
