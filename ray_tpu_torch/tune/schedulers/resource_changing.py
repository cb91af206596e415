"""ResourceChangingScheduler: grow trial resources as the population
thins out.

Reference: ``python/ray/tune/schedulers/resource_changing_scheduler.py``
— wraps a base scheduler; after each result, a ``resources_allocation_
function`` may return new per-trial resources, and the trial is paused
so the controller restarts its actor with the new allocation (restore
from checkpoint). ``DistributeResources`` is the reference's built-in
policy: split the cluster's CPU/GPU budget evenly over live trials,
growing survivors as ASHA/PBT kill the rest.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler, TrialScheduler)


class DistributeResources:
    """Even split of the total budget over live trials (reference:
    ``DistributeResources`` in resource_changing_scheduler.py). The JAX
    package splits ``TPU``; the port splits ``GPU``, with the same floor
    division."""

    def __init__(self, total_cpus: Optional[float] = None,
                 total_gpus: Optional[float] = None):
        self.total_cpus = total_cpus
        self.total_gpus = total_gpus

    def __call__(self, controller, trial) -> Optional[Dict[str, float]]:
        live = [t for t in controller.trials
                if controller.is_live(t.trial_id)]
        n = max(1, len(live))
        if self.total_cpus is None:
            try:
                import ray_tpu_torch
                self.total_cpus = ray_tpu_torch.cluster_resources().get(
                    "CPU", 1.0)
                self.total_gpus = self.total_gpus or \
                    ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            except Exception:
                return None
        out = {"CPU": max(1.0, self.total_cpus // n)}
        if self.total_gpus:
            out["GPU"] = self.total_gpus // n
        return out


class ResourceChangingScheduler(TrialScheduler):
    def __init__(self, base_scheduler: Optional[TrialScheduler] = None,
                 resources_allocation_function: Optional[
                     Callable] = None):
        base = base_scheduler or FIFOScheduler()
        super().__init__(base.metric, base.mode)
        self.base = base
        self.alloc = resources_allocation_function or \
            DistributeResources()
        #: trial_id -> last allocation we applied (avoid churn)
        self._current: Dict[str, Dict[str, float]] = {}
        self.reallocation_count = 0

    def set_search_properties(self, metric, mode) -> bool:
        super().set_search_properties(metric, mode)
        return self.base.set_search_properties(metric, mode)

    def on_trial_add(self, controller, trial) -> None:
        self.base.on_trial_add(controller, trial)

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        decision = self.base.on_trial_result(controller, trial, result)
        if decision != self.CONTINUE:
            return decision
        want = None
        try:
            want = self.alloc(controller, trial)
        except Exception:
            pass
        if not want:
            return decision
        have = self._current.get(trial.trial_id) \
            or dict(getattr(trial, "resources", None) or {"CPU": 1.0})
        if any(want.get(k, 0) != have.get(k, 0) for k in want):
            # the controller checkpoints, stops the actor, and restarts
            # it under the new allocation (reference: trial is paused
            # with new placement-group factory, then unpaused). Record
            # the allocation only on success so a declined reallocation
            # (no checkpoint yet) retries on the next result.
            if controller.reallocate_trial(trial, want):
                self._current[trial.trial_id] = dict(want)
                self.reallocation_count += 1
                return self.NOOP
        return decision

    def on_trial_complete(self, controller, trial, result: Dict) -> None:
        self._current.pop(trial.trial_id, None)
        self.base.on_trial_complete(controller, trial, result)

    def on_trial_error(self, controller, trial) -> None:
        self._current.pop(trial.trial_id, None)
        self.base.on_trial_error(controller, trial)
