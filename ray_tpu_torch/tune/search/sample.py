"""Search-space DSL: tune.uniform / loguniform / choice / randint / ...

Reference: ``python/ray/tune/search/sample.py`` — Domain objects carried
in ``param_space`` dicts, resolved per-trial by the variant generator.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: Optional[float] = None):
        if log and lower <= 0:
            raise ValueError("loguniform needs lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math
            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(round(v / self.q) * self.q, 10)
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False,
                 q: Optional[int] = None):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> int:
        if self.log:
            import math
            v = int(math.exp(rng.uniform(math.log(self.lower),
                                         math.log(self.upper))))
        else:
            v = rng.randint(self.lower, self.upper - 1)
        if self.q:
            v = int(round(v / self.q) * self.q)
        return max(self.lower, min(v, self.upper - 1))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng: random.Random) -> Any:
        try:
            return self.fn(None)
        except TypeError:
            return self.fn()


class GridSearch:
    """Marker resolved exhaustively by the variant generator."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# -- public constructors (reference API names) ------------------------
def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, log=True, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    # Reference encodes grid_search as {"grid_search": [...]} in dicts.
    return {"grid_search": list(values)}


def randn(mean: float = 0.0, sd: float = 1.0) -> Function:
    return Function(lambda: random.gauss(mean, sd))
