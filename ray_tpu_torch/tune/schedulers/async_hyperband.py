"""ASHA: asynchronous successive halving.

Reference: ``python/ray/tune/schedulers/async_hyperband.py`` — rungs at
``grace_period * reduction_factor**k``; a trial reaching a rung is
stopped unless its metric is in the top ``1/reduction_factor`` quantile
of everything recorded at that rung.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler
from ray_tpu_torch.tune.trainable import TRAINING_ITERATION


class _Bracket:
    def __init__(self, min_t: float, max_t: float, rf: float, s: int):
        self.rf = rf
        # rung milestones, ascending
        self.rungs: List[tuple] = []
        t = min_t * rf ** s
        milestones = []
        while t < max_t:
            milestones.append(t)
            t *= rf
        self.rungs = [(m, {}) for m in sorted(milestones)]

    def on_result(self, trial_id: str, cur_iter: float,
                  score: Optional[float]) -> str:
        decision = TrialScheduler.CONTINUE
        for milestone, recorded in self.rungs:
            if cur_iter < milestone or trial_id in recorded:
                continue
            if score is None:
                recorded[trial_id] = None
                continue
            others = [v for v in recorded.values() if v is not None]
            recorded[trial_id] = score
            if others:
                others_sorted = sorted(others)
                k = int(len(others_sorted) * (1 - 1 / self.rf))
                cutoff = others_sorted[min(k, len(others_sorted) - 1)]
                if score < cutoff:
                    decision = TrialScheduler.STOP
        return decision


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = TRAINING_ITERATION,
                 max_t: float = 100, grace_period: float = 1,
                 reduction_factor: float = 4, brackets: int = 1):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self._brackets = [
            _Bracket(grace_period, max_t, reduction_factor, s)
            for s in range(brackets)]
        self._trial_bracket: Dict[str, _Bracket] = {}
        self._counter = 0

    def on_trial_add(self, controller, trial) -> None:
        b = self._brackets[self._counter % len(self._brackets)]
        self._counter += 1
        self._trial_bracket[trial.trial_id] = b

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        cur = result.get(self.time_attr)
        if cur is None:
            return self.CONTINUE
        if cur >= self.max_t:
            return self.STOP
        b = self._trial_bracket.get(trial.trial_id)
        if b is None:
            self.on_trial_add(controller, trial)
            b = self._trial_bracket[trial.trial_id]
        return b.on_result(trial.trial_id, cur, self._score(result))


ASHAScheduler = AsyncHyperBandScheduler
