"""PB2: Population Based Bandits.

Reference: ``python/ray/tune/schedulers/pb2.py`` — PBT's
exploit/explore loop, but EXPLORE selects new hyperparameters with a
Gaussian-process bandit (GP-UCB) fit on the population's observed
(time, config) → reward-change data, instead of PBT's random
×0.8/×1.2 perturbation. Sample-efficient for small populations. The
reference uses GPy; here the GP (RBF kernel, fixed noise, UCB
acquisition over random candidates) is ~60 lines of numpy — same
algorithm, no dependency.
"""

from __future__ import annotations

import math

from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining
from ray_tpu_torch.tune.trainable import TRAINING_ITERATION


class _GP:
    """Minimal RBF-kernel GP regression (zero mean, fixed noise)."""

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-3):
        self.ls = lengthscale
        self.noise = noise
        self._X: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._L: Optional[np.ndarray] = None

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self._X = X
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y))

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xs, self._X)
        mu = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-9, None)
        return mu, np.sqrt(var)


class PB2(PopulationBasedTraining):
    """PBT with GP-UCB explore. ``hyperparam_bounds`` maps each tuned
    key to ``[low, high]`` (continuous; log-scaled when both bounds are
    positive and span >=2 decades, matching the reference's guidance to
    pass log-spaced bounds)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 time_attr: str = TRAINING_ITERATION,
                 perturbation_interval: float = 10,
                 hyperparam_bounds: Optional[Dict[str, List[float]]] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 2.0,
                 num_candidates: int = 256,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("PB2 requires hyperparam_bounds")
        super().__init__(
            metric=metric, mode=mode, time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={}, quantile_fraction=quantile_fraction,
            seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self._log_keys = {
            k for k, (lo, hi) in self.bounds.items()
            if lo > 0 and hi / lo >= 100}
        self.kappa = ucb_kappa
        self.num_candidates = num_candidates
        self._np_rng = np.random.default_rng(seed)
        #: observations: (t, config-vector, score) per report; reward
        #: CHANGE between consecutive reports of one trial is the GP
        #: target (the reference models score deltas, pb2_utils.py)
        self._obs: List[Tuple[float, np.ndarray, float]] = []
        self._prev_score: Dict[str, float] = {}
        self._t_max = 1.0

    # -- encoding ------------------------------------------------------
    def _encode(self, t: float, config: Dict) -> np.ndarray:
        out = [t / max(1.0, self._t_max)]
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            if k in self._log_keys:
                out.append((math.log(v) - math.log(lo))
                           / (math.log(hi) - math.log(lo)))
            else:
                out.append((v - lo) / (hi - lo))
        return np.clip(np.asarray(out), 0.0, 1.0)

    def _decode_candidate(self, x: np.ndarray) -> Dict:
        cfg = {}
        for i, (k, (lo, hi)) in enumerate(self.bounds.items()):
            u = float(np.clip(x[i], 0.0, 1.0))
            if k in self._log_keys:
                cfg[k] = math.exp(math.log(lo)
                                  + u * (math.log(hi) - math.log(lo)))
            else:
                cfg[k] = lo + u * (hi - lo)
        return cfg

    # -- data collection ----------------------------------------------
    def on_trial_result(self, controller, trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is not None and score is not None:
            self._t_max = max(self._t_max, float(t))
            prev = self._prev_score.get(trial.trial_id)
            self._prev_score[trial.trial_id] = score
            if prev is not None:
                self._obs.append((float(t),
                                  self._encode(t, trial.config),
                                  score - prev))
                del self._obs[:-512]
        return super().on_trial_result(controller, trial, result)

    # -- explore: GP-UCB over candidates ------------------------------
    def _gp_explore(self, base_config: Dict, t: float) -> Dict:
        new = dict(base_config)
        if len(self._obs) < 4:
            # cold start: uniform sample inside bounds (reference
            # behavior before the GP has data)
            x = self._np_rng.uniform(size=len(self.bounds))
            new.update(self._decode_candidate(x))
            return new
        X = np.stack([np.concatenate(([o[0] / max(1.0, self._t_max)],
                                      o[1][1:]))
                      for o in self._obs])
        y = np.asarray([o[2] for o in self._obs])
        y_std = y.std() or 1.0
        gp = _GP()
        gp.fit(X, (y - y.mean()) / y_std)
        cand = self._np_rng.uniform(
            size=(self.num_candidates, len(self.bounds)))
        t_col = np.full((self.num_candidates, 1),
                        t / max(1.0, self._t_max))
        mu, sd = gp.predict(np.hstack([t_col, cand]))
        best = cand[int(np.argmax(mu + self.kappa * sd))]
        new.update(self._decode_candidate(best))
        return new

    def _make_exploit_config(self, source_config: Dict,
                             t: float) -> Dict:
        return self._gp_explore(source_config, t)
