"""BOHB: Bayesian Optimization + HyperBand.

Reference: ``python/ray/tune/schedulers/hb_bohb.py`` (HyperBandForBOHB
— HyperBand bracketing whose next-trial configs come from the paired
model-based searcher) and ``python/ray/tune/search/bohb/`` (TuneBOHB —
ConfigSpace KDE model). The reference depends on the external ``hpbandster``
package; here the BOHB model itself (per-dimension KDE split into
good/bad sets, sample from good, rank by good/bad density ratio —
Falkner et al. 2018, Algorithm 2) is implemented directly, so no
dependency. The scheduler side reuses the ASHA rung machinery: BOHB's
asynchronous variant (the reference docs recommend it at scale).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.schedulers.async_hyperband import (
    AsyncHyperBandScheduler)
from ray_tpu_torch.tune.search.sample import Categorical, Domain, Float, Integer
from ray_tpu_torch.tune.search.searcher import Searcher


class HyperBandForBOHB(AsyncHyperBandScheduler):
    """HyperBand bracketing that feeds rung results back into a paired
    TuneBOHB searcher so its KDE model trains on partial-budget scores
    (reference: hb_bohb.py links scheduler rungs to searcher budgets)."""

    def __init__(self, searcher: Optional["TuneBOHB"] = None, **kwargs):
        super().__init__(**kwargs)
        self._searcher = searcher

    def link_searcher(self, searcher: "TuneBOHB") -> None:
        self._searcher = searcher

    def on_trial_result(self, controller, trial, result: Dict) -> str:
        decision = super().on_trial_result(controller, trial, result)
        if self._searcher is not None:
            score = self._score(result)
            t = result.get(self.time_attr)
            if score is not None and t is not None:
                self._searcher.observe(trial.config, float(t), score)
        return decision


class TuneBOHB(Searcher):
    """Model-based suggestions: TPE/KDE over the search space.

    After ``min_points`` observations at the largest budget with data,
    splits them into good/bad by ``top_fraction``, fits per-dimension
    kernel densities, samples candidates from the good KDE and keeps
    the best good/bad likelihood ratio. Before that: random sampling.
    """

    def __init__(self, space: Dict[str, Domain],
                 metric: Optional[str] = None,
                 mode: str = "max",
                 min_points: int = 8,
                 top_fraction: float = 0.25,
                 num_candidates: int = 64,
                 random_fraction: float = 0.2,
                 bandwidth: float = 0.15,
                 seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode)
        self.space = dict(space)
        self.min_points = min_points
        self.top_fraction = top_fraction
        self.num_candidates = num_candidates
        self.random_fraction = random_fraction
        self.bw = bandwidth
        self._rng = random.Random(seed)
        self._np = np.random.default_rng(seed)
        #: budget -> list of (encoded config, score); the model trains
        #: on the LARGEST budget with >= min_points (BOHB Algorithm 2)
        self._data: Dict[float, List] = {}

    # ------------------------------------------------------- encoding
    def _encode_val(self, key: str, v) -> float:
        d = self.space[key]
        if isinstance(d, Categorical):
            return d.categories.index(v) / max(1, len(d.categories) - 1)
        lo, hi = float(d.lower), float(d.upper)
        if getattr(d, "log", False):
            return (math.log(float(v)) - math.log(lo)) / \
                (math.log(hi) - math.log(lo))
        return (float(v) - lo) / (hi - lo)

    def _encode(self, config: Dict) -> np.ndarray:
        return np.asarray([
            self._encode_val(k, config[k])
            for k in self.space if k in config])

    # ------------------------------------------------------ observing
    def observe(self, config: Dict, budget: float, score: float) -> None:
        if not all(k in config for k in self.space):
            return
        self._data.setdefault(budget, []).append(
            (self._encode(config), score))

    # ----------------------------------------------------- suggesting
    def _kde_logpdf(self, pts: np.ndarray, x: np.ndarray) -> float:
        # product of per-dimension gaussian KDEs (BOHB's factorized KDE)
        d2 = (pts - x[None, :]) ** 2
        per_dim = np.exp(-0.5 * d2 / self.bw ** 2).mean(0) + 1e-12
        return float(np.log(per_dim).sum())

    def suggest(self, trial_id: str) -> Optional[Dict]:
        budgets = sorted(
            (b for b, rows in self._data.items()
             if len(rows) >= self.min_points), reverse=True)
        if not budgets or self._rng.random() < self.random_fraction:
            return {k: d.sample(self._rng)
                    for k, d in self.space.items()}
        rows = self._data[budgets[0]]
        rows_sorted = sorted(rows, key=lambda r: r[1], reverse=True)
        n_good = max(2, int(len(rows_sorted) * self.top_fraction))
        good = np.stack([r[0] for r in rows_sorted[:n_good]])
        bad = np.stack([r[0] for r in rows_sorted[n_good:]]) \
            if len(rows_sorted) > n_good else None

        best_x, best_ratio = None, -math.inf
        for _ in range(self.num_candidates):
            # sample around a random good point (KDE sampling)
            center = good[self._np.integers(len(good))]
            x = np.clip(center + self._np.normal(
                0, self.bw, size=center.shape), 0.0, 1.0)
            ratio = self._kde_logpdf(good, x) - (
                self._kde_logpdf(bad, x) if bad is not None else 0.0)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        return self._decode(best_x)

    def _decode(self, x: np.ndarray) -> Dict:
        cfg = {}
        for i, (k, d) in enumerate(self.space.items()):
            u = float(np.clip(x[i], 0.0, 1.0))
            if isinstance(d, Categorical):
                cfg[k] = d.categories[
                    int(round(u * (len(d.categories) - 1)))]
                continue
            lo, hi = float(d.lower), float(d.upper)
            if getattr(d, "log", False):
                v = math.exp(math.log(lo)
                             + u * (math.log(hi) - math.log(lo)))
            else:
                v = lo + u * (hi - lo)
            if isinstance(d, Integer):
                v = int(round(v))
            cfg[k] = v
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[Dict]
                          = None, error: bool = False) -> None:
        pass
