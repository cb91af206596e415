"""Searcher interface + built-in search algorithms, the port of
``ray_tpu/tune/search/searcher.py``.

Reference: ``python/ray/tune/search/searcher.py`` (``Searcher`` ABC with
``suggest``/``on_trial_complete``), ``basic_variant.py``
(``BasicVariantGenerator``: grid + random, the default), and the wrapper
pattern of ``concurrency_limiter.py``. The searchers over third-party
packages (``OptunaSearch``, ``HyperOptSearch``, ``BayesOptSearch``)
raise: they wait for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from typing import Dict, List, Optional

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


def _waits(name: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"tune.search.{name} waits for the port of tune/'s optional "
            f"searchers (ROADMAP Queue 1 item 11)")
    return type(name, (Searcher,), {"__init__": __init__,
                                     "__doc__": f"{name}: not ported yet."})


OptunaSearch = _waits("OptunaSearch")
HyperOptSearch = _waits("HyperOptSearch")
BayesOptSearch = _waits("BayesOptSearch")
