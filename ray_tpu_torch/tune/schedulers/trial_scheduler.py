"""TrialScheduler interface + FIFO.

Reference: ``python/ray/tune/schedulers/trial_scheduler.py`` —
``on_trial_result`` returns CONTINUE/PAUSE/STOP; the controller enacts
the decision.
"""

from __future__ import annotations

from typing import Dict, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"
    #: the scheduler already enacted its own lifecycle change (e.g. a
    #: resource reallocation restarted the actor): the controller must
    #: take no further action on this result
    NOOP = "NOOP"

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_add(self, controller, trial) -> None:
        pass

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, controller, trial, result: Dict) -> None:
        pass

    def on_trial_error(self, controller, trial) -> None:
        pass

    def _score(self, result: Dict) -> Optional[float]:
        if self.metric is None or self.metric not in result:
            return None
        v = float(result[self.metric])
        return v if self.mode != "min" else -v


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference default)."""
