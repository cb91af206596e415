"""ResultGrid: the outcome of a Tuner.fit().

Reference: ``python/ray/tune/result_grid.py`` — a list of per-trial
Results with best-result selection.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.train.result import Result
from ray_tpu_torch.tune.experiment import ERROR, Trial


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str] = None,
                 mode: str = "max", experiment_path: str = ""):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self.experiment_path = experiment_path
        self._results = [
            Result(metrics=t.last_result or None,
                   checkpoint=t.checkpoint,
                   path=experiment_path,
                   error=t.error)
            for t in trials]

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._trials if t.status != ERROR)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("No metric given to get_best_result and none "
                             "set in TuneConfig.")
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise RuntimeError(f"No trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return (max if mode == "max" else min)(scored, key=key)

    def get_dataframe(self):
        import pandas as pd
        return pd.DataFrame([dict(r.metrics or {}) for r in self._results])
