"""Searcher interface + built-in search algorithms, the port of
``ray_tpu/tune/search/searcher.py``.

Reference: ``python/ray/tune/search/searcher.py`` (``Searcher`` ABC with
``suggest``/``on_trial_complete``), ``basic_variant.py``
(``BasicVariantGenerator``: grid + random, the default), and the wrapper
pattern of ``concurrency_limiter.py``. Third-party searchers (hyperopt,
optuna, …) follow the same interface; OptunaSearch, HyperOptSearch and
BayesOptSearch are provided gated on their optional packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.search.variant_generator import generate_variants


class Searcher:
    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str],
                              config: Dict, **kwargs) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict]:
        """Next config; None = nothing available right now (the
        controller re-asks later unless ``is_finished()``)."""
        raise NotImplementedError

    def is_finished(self) -> bool:
        """True when this searcher will never produce another config."""
        return False

    def on_trial_result(self, trial_id: str, result: Dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid + random sampling (reference default searcher)."""

    def __init__(self, points_to_evaluate: Optional[List[Dict]] = None,
                 max_concurrent: int = 0,
                 random_state: Optional[int] = None):
        super().__init__()
        self._points = list(points_to_evaluate or [])
        self._space: Optional[Dict] = None
        self._num_samples = 1
        self._variants = None
        self._seed = random_state
        self._exhausted = False
        self.max_concurrent = max_concurrent

    def set_search_properties(self, metric, mode, config,
                              num_samples: int = 1) -> bool:
        super().set_search_properties(metric, mode, config)
        self._space = config
        self._num_samples = num_samples
        self._variants = iter(self._make())
        return True

    def _make(self):
        for p in self._points:
            yield dict(p)
        if self._space is not None:
            remaining = self._num_samples
            yield from generate_variants(
                self._space, num_samples=remaining, seed=self._seed)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if self._variants is None:
            self._variants = iter(self._make())
        try:
            return next(self._variants)
        except StopIteration:
            self._exhausted = True
            return None

    def is_finished(self) -> bool:
        return self._exhausted

    @property
    def total_samples(self) -> int:
        from ray_tpu_torch.tune.search.variant_generator import _find_grids
        n_grid = 1
        for _, vals in _find_grids(self._space or {}):
            n_grid *= max(1, len(vals))
        return len(self._points) + n_grid * self._num_samples


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, config, **kw) -> bool:
        return self.searcher.set_search_properties(metric, mode, config, **kw)

    def suggest(self, trial_id: str) -> Optional[Dict]:
        if len(self._live) >= self.max_concurrent:
            return None  # transient — controller re-asks later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def is_finished(self) -> bool:
        return self.searcher.is_finished()

    @property
    def total_samples(self):
        return getattr(self.searcher, "total_samples", None)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)


class OptunaSearch(Searcher):
    """TPE via optuna, if installed (reference ``search/optuna/``)."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, seed: Optional[int] = None):
        super().__init__(metric, mode)
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires `optuna`, which is not installed."
            ) from e
        self._seed = seed
        self._study = None
        self._space = None
        self._live: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode, config, **kw) -> bool:
        super().set_search_properties(metric, mode, config)
        import optuna
        self._space = config
        direction = "maximize" if self.mode == "max" else "minimize"
        sampler = optuna.samplers.TPESampler(seed=self._seed)
        self._study = optuna.create_study(
            direction=direction, sampler=sampler)
        return True

    def suggest(self, trial_id: str) -> Optional[Dict]:
        from ray_tpu_torch.tune.search import sample as s
        ot = self._study.ask()
        cfg = {}
        for k, v in (self._space or {}).items():
            if isinstance(v, s.Float):
                cfg[k] = ot.suggest_float(k, v.lower, v.upper, log=v.log)
            elif isinstance(v, s.Integer):
                cfg[k] = ot.suggest_int(k, v.lower, v.upper - 1, log=v.log)
            elif isinstance(v, s.Categorical):
                cfg[k] = ot.suggest_categorical(k, v.categories)
            elif isinstance(v, s.Domain):
                cfg[k] = v.sample(__import__("random").Random())
            else:
                cfg[k] = v
        self._live[trial_id] = ot
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        ot = self._live.pop(trial_id, None)
        if ot is None or self._study is None:
            return
        if error or not result or self.metric not in result:
            self._study.tell(ot, state=__import__(
                "optuna").trial.TrialState.FAIL)
        else:
            self._study.tell(ot, result[self.metric])


class HyperOptSearch(Searcher):
    """TPE via hyperopt, if installed (reference ``search/hyperopt/``).
    Tuned keys come from hyperopt; constants and unsupported domains
    pass through / sample from the DSL so the trial config is always
    complete."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 n_initial_points: int = 20,
                 random_state_seed: Optional[int] = None):
        super().__init__(metric, mode)
        try:
            import hyperopt  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "HyperOptSearch requires `hyperopt`, which is not baked "
                "into the hermetic image — add it to the image, or "
                "use the built-in BasicVariantGenerator / schedulers."
            ) from e
        self._n_initial = n_initial_points
        self._seed = random_state_seed
        self._space_cfg: Dict[str, Any] = {}
        self._domain = None
        self._trials = None
        self._live: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode, config, **kw) -> bool:
        super().set_search_properties(metric, mode, config)
        import math

        import hyperopt as hpo

        from ray_tpu_torch.tune.search import sample as s
        self._space_cfg = dict(config or {})
        space = {}
        for k, v in self._space_cfg.items():
            if isinstance(v, s.Float):
                space[k] = (hpo.hp.loguniform(k, math.log(v.lower),
                                              math.log(v.upper))
                            if v.log else hpo.hp.uniform(k, v.lower, v.upper))
            elif isinstance(v, s.Integer):
                if v.log:
                    # hyperopt has no log-int primitive: round a
                    # qloguniform sample (preserves the log intent)
                    space[k] = hpo.hp.qloguniform(
                        k, math.log(v.lower), math.log(v.upper - 1), 1)
                else:
                    space[k] = hpo.hp.randint(k, v.lower, v.upper)
            elif isinstance(v, s.Categorical):
                space[k] = hpo.hp.choice(k, v.categories)
            # constants / other domains stay out of the hyperopt space
        self._hpo_keys = set(space)
        self._domain = hpo.Domain(lambda spc: 0, space)
        self._trials = hpo.Trials()
        return True

    def _base_config(self) -> Dict[str, Any]:
        import random

        from ray_tpu_torch.tune.search import sample as s
        rng = random.Random(self._seed)
        out = {}
        for k, v in self._space_cfg.items():
            if k in self._hpo_keys:
                continue
            out[k] = v.sample(rng) if isinstance(v, s.Domain) else v
        return out

    def suggest(self, trial_id: str) -> Optional[Dict]:
        import numpy as np

        import hyperopt as hpo

        from ray_tpu_torch.tune.search import sample as s
        n = len(self._trials.trials)
        rng = np.random.default_rng(
            self._seed + n if self._seed is not None else None)
        new = hpo.tpe.suggest(
            [n], self._domain, self._trials,
            rng.integers(0, 2 ** 31 - 1),
            n_startup_jobs=self._n_initial)
        self._trials.insert_trial_docs(new)
        self._trials.refresh()
        vals = {k: v[0] for k, v in new[0]["misc"]["vals"].items() if v}
        cfg = self._base_config()
        for k in self._hpo_keys:
            if k not in vals:
                continue
            v = self._space_cfg[k]
            if isinstance(v, s.Categorical):
                cfg[k] = v.categories[int(vals[k])]  # hp.choice -> index
            elif isinstance(v, s.Integer):
                cfg[k] = max(v.lower, min(v.upper - 1, int(vals[k])))
            else:
                cfg[k] = float(vals[k])
        self._live[trial_id] = new[0]["tid"]
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        tid = self._live.pop(trial_id, None)
        if tid is None:
            return
        import hyperopt as hpo
        for t in self._trials.trials:
            if t["tid"] == tid:
                if error or not result or self.metric not in result:
                    t["state"] = hpo.JOB_STATE_ERROR
                else:
                    val = result[self.metric]
                    loss = -val if self.mode == "max" else val
                    t["result"] = {"loss": loss,
                                   "status": hpo.STATUS_OK}
                    t["state"] = hpo.JOB_STATE_DONE
        self._trials.refresh()


class BayesOptSearch(Searcher):
    """Gaussian-process search via bayesian-optimization, if installed
    (reference ``search/bayesopt/``). Like the reference, only
    continuous Float/Integer domains are optimizable — Categorical
    raises loudly; constants pass through."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 random_state: int = 42, **kwargs):
        super().__init__(metric, mode)
        try:
            import bayes_opt  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "BayesOptSearch requires `bayesian-optimization`, which "
                "is not baked into the hermetic image — add it to "
                "the image, or use the built-in searchers/schedulers."
            ) from e
        self._random_state = random_state
        self._kwargs = kwargs
        self._optimizer = None
        self._utility = None
        self._space_cfg: Dict[str, Any] = {}
        self._live: Dict[str, Dict] = {}

    def set_search_properties(self, metric, mode, config, **kw) -> bool:
        super().set_search_properties(metric, mode, config)
        from bayes_opt import BayesianOptimization

        from ray_tpu_torch.tune.search import sample as s
        self._space_cfg = dict(config or {})
        bounds = {}
        for k, v in self._space_cfg.items():
            if isinstance(v, (s.Float, s.Integer)):
                bounds[k] = (v.lower, v.upper)
            elif isinstance(v, s.Domain):
                raise ValueError(
                    f"BayesOptSearch only supports continuous "
                    f"float/integer domains; {k!r} is "
                    f"{type(v).__name__} (reference behavior: bayesopt "
                    f"rejects non-continuous spaces)")
        self._optimizer = BayesianOptimization(
            f=None, pbounds=bounds, random_state=self._random_state,
            allow_duplicate_points=True, **self._kwargs)
        # UtilityFunction exists in <2.0 and suggest() requires it
        # there; 2.x suggests without one
        try:
            from bayes_opt import UtilityFunction
            try:
                self._utility = UtilityFunction(kind="ucb", kappa=2.576,
                                                xi=0.0)
            except TypeError:
                self._utility = UtilityFunction()
        except ImportError:
            self._utility = None
        return True

    def suggest(self, trial_id: str) -> Optional[Dict]:
        import random

        from ray_tpu_torch.tune.search import sample as s
        try:
            raw = (self._optimizer.suggest(self._utility)
                   if self._utility is not None
                   else self._optimizer.suggest())
        except TypeError:
            raw = self._optimizer.suggest()
        rng = random.Random(self._random_state)
        cfg = {}
        for k, v in self._space_cfg.items():
            if k in raw:
                if isinstance(v, s.Integer):
                    cfg[k] = max(v.lower,
                                 min(v.upper - 1, int(round(raw[k]))))
                else:
                    cfg[k] = float(raw[k])
            else:
                cfg[k] = v.sample(rng) if isinstance(v, s.Domain) else v
        self._live[trial_id] = dict(raw)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result \
                or self.metric not in result:
            return
        val = result[self.metric]
        target = val if self.mode == "max" else -val
        self._optimizer.register(params=cfg, target=target)
