"""Population Based Training.

Reference: ``python/ray/tune/schedulers/pbt.py`` — every
``perturbation_interval``, bottom-quantile trials EXPLOIT a top-quantile
trial (clone weights via checkpoint + copy config) and EXPLORE (mutate
hyperparams: resample with prob ``resample_probability``, else
perturb ×1.2/×0.8). The controller performs the actual clone via
save/restore on the trial actors.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Union

from ray_tpu_torch.tune.schedulers.trial_scheduler import TrialScheduler
from ray_tpu_torch.tune.search.sample import Domain
from ray_tpu_torch.tune.trainable import TRAINING_ITERATION


def _explore(config: Dict, mutations: Dict, resample_prob: float,
             rng: random.Random) -> Dict:
    new = dict(config)
    for key, spec in mutations.items():
        old = config.get(key)
        if rng.random() < resample_prob or old is None:
            if isinstance(spec, Domain):
                new[key] = spec.sample(rng)
            elif isinstance(spec, list):
                new[key] = rng.choice(spec)
            elif callable(spec):
                new[key] = spec()
        else:
            if isinstance(spec, list):
                # move to a neighboring listed value
                try:
                    i = spec.index(old)
                    j = max(0, min(len(spec) - 1,
                                   i + rng.choice([-1, 1])))
                    new[key] = spec[j]
                except ValueError:
                    new[key] = rng.choice(spec)
            elif isinstance(old, (int, float)):
                factor = rng.choice([0.8, 1.2])
                new[key] = type(old)(old * factor)
    return new


class PopulationBasedTraining(TrialScheduler):
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = TRAINING_ITERATION,
                 perturbation_interval: float = 10,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 synch: bool = False,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.synch = synch
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._latest: Dict[str, float] = {}  # trial_id -> score
        # synch mode: trial_id -> score for trials waiting at the
        # current perturbation boundary.
        self._at_boundary: Dict[str, float] = {}
        self._round = 1
        self.perturbation_count = 0

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return self.CONTINUE
        self._latest[trial.trial_id] = score
        if self.synch:
            return self._synch_step(controller, trial, t, score)
        last = self._last_perturb.get(trial.trial_id, 0.0)
        if t - last < self.interval:
            return self.CONTINUE

        # Exploit sources are any scored trial we can still clone from:
        # live ones (checkpointed on demand) or terminated ones that left
        # a checkpoint behind. Restricting to live trials deadlocks PBT
        # when population members run serially (a fast trial can finish
        # before a slow one produces its first score).
        candidates = {}
        for tid, s in self._latest.items():
            other = controller.get_trial(tid)
            if other is None:
                continue
            if controller.is_live(tid) or other.checkpoint is not None:
                candidates[tid] = s
        if len(candidates) < 2:
            # Population not comparable yet — keep the perturbation slot
            # so the next report retries instead of waiting a full
            # interval.
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        live = candidates
        ordered = sorted(live, key=live.get)
        n_q = max(1, int(len(ordered) * self.quantile))
        bottom = set(ordered[:n_q])
        top = ordered[-n_q:]
        if trial.trial_id not in bottom:
            return self.CONTINUE
        source_id = self._rng.choice(
            [tid for tid in top if tid != trial.trial_id] or top)
        source = controller.get_trial(source_id)
        if source is None or source is trial:
            return self.CONTINUE
        new_config = self._make_exploit_config(source.config, t)
        controller.exploit_trial(trial, source, new_config)
        self.perturbation_count += 1
        return self.CONTINUE

    def _make_exploit_config(self, source_config: Dict,
                             t: float) -> Dict:
        """EXPLORE hook: PBT mutates randomly; PB2 overrides with its
        GP-UCB selection (reference: pb2.py explore())."""
        return _explore(source_config, self.mutations,
                        self.resample_prob, self._rng)

    # -- synchronous mode (reference pbt.py `synch=True`) --------------
    # Trials PAUSE at each perturbation boundary (t >= round*interval)
    # until the whole live population has arrived; the last arrival
    # runs the exploit/explore round, everyone resumes together. This
    # makes PBT deterministic under any trial interleaving.
    def _synch_step(self, controller, trial, t: float,
                    score: float) -> str:
        if t < self._round * self.interval:
            return self.CONTINUE
        self._at_boundary[trial.trial_id] = score
        if self._outstanding(controller):
            return self.PAUSE
        self._run_round(controller)
        # The caller resumes via the controller's CONTINUE path; the
        # paused cohort was resumed inside _run_round.
        return self.CONTINUE

    def _outstanding(self, controller) -> bool:
        """Any live trial that has not reached the boundary yet?"""
        for other in controller.trials:
            if other.trial_id in self._at_boundary:
                continue
            if controller.is_live(other.trial_id):
                return True
        return False

    def _run_round(self, controller) -> None:
        cohort = dict(self._at_boundary)
        self._at_boundary.clear()
        self._round += 1
        if len(cohort) >= 2:
            ordered = sorted(cohort, key=cohort.get)
            n_q = max(1, int(len(ordered) * self.quantile))
            bottom = [tid for tid in ordered[:n_q]
                      if controller.is_live(tid)]
            top = ordered[-n_q:]
            for tid in bottom:
                target = controller.get_trial(tid)
                pool = [s for s in top if s != tid]
                if target is None or not pool:
                    continue
                source = controller.get_trial(self._rng.choice(pool))
                if source is None:
                    continue
                new_config = self._make_exploit_config(
                    source.config, self._round * self.interval)
                controller.exploit_trial(target, source, new_config)
                self.perturbation_count += 1
        for tid in cohort:
            other = controller.get_trial(tid)
            if other is not None:
                controller.unpause_trial(other)

    def on_trial_complete(self, controller, trial, result: Dict) -> None:
        if not self.synch:
            return
        # A finished trial can no longer block the boundary; if it was
        # the straggler, run the round now so the paused cohort resumes.
        self._at_boundary.pop(trial.trial_id, None)
        if self._at_boundary and not self._outstanding(controller):
            self._run_round(controller)
