"""Median stopping rule.

Reference: ``python/ray/tune/schedulers/median_stopping_rule.py`` — stop
a trial at time t if its best result so far is worse than the median of
other trials' running averages up to t.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler
from ray_tpu_torch.tune.trainable import TRAINING_ITERATION


class MedianStoppingRule(TrialScheduler):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = TRAINING_ITERATION,
                 grace_period: float = 5, min_samples_required: int = 3,
                 hard_stop: bool = True):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.hard_stop = hard_stop
        # trial_id -> list of (t, score)
        self._history: Dict[str, List[tuple]] = {}

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return self.CONTINUE
        self._history.setdefault(trial.trial_id, []).append((t, score))
        if t < self.grace_period:
            return self.CONTINUE
        medians = []
        for other_id, hist in self._history.items():
            if other_id == trial.trial_id:
                continue
            upto = [s for (tt, s) in hist if tt <= t]
            if upto:
                medians.append(sum(upto) / len(upto))
        if len(medians) < self.min_samples:
            return self.CONTINUE
        best = max(s for (_, s) in self._history[trial.trial_id])
        if best < statistics.median(medians):
            return self.STOP if self.hard_stop else self.PAUSE
        return self.CONTINUE
