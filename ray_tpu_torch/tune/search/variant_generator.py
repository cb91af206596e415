"""Resolve a param_space into concrete trial configs.

Reference: ``python/ray/tune/search/variant_generator.py`` —
``generate_variants``: cartesian product over every ``grid_search`` in
the (nested) space, with Domain objects sampled per variant.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Tuple

from ray_tpu_torch.tune.search.sample import Domain, GridSearch


def _find_grids(space: Any, path: Tuple = ()) -> List[Tuple[Tuple, List]]:
    grids = []
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return [(path, list(space["grid_search"]))]
        for k, v in space.items():
            grids.extend(_find_grids(v, path + (k,)))
    elif isinstance(space, GridSearch):
        grids.append((path, space.values))
    return grids


def _assign(config: Dict, path: Tuple, value: Any) -> None:
    d = config
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def _resolve(space: Any, rng: random.Random) -> Any:
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            return space  # replaced by grid assignment
        return {k: _resolve(v, rng) for k, v in space.items()}
    if isinstance(space, Domain):
        return space.sample(rng)
    if isinstance(space, GridSearch):
        return space
    return space


def generate_variants(space: Dict, num_samples: int = 1,
                      seed: int = None) -> Iterator[Dict]:
    """Yield ``num_samples`` x (cartesian grid product) concrete configs.

    Reference semantics (``basic_variant.py``): num_samples repeats the
    whole grid; random Domains resample per repeat.
    """
    rng = random.Random(seed)
    grids = _find_grids(space)
    grid_values = [v for _, v in grids]
    for _ in range(num_samples):
        if grids:
            for combo in itertools.product(*grid_values):
                config = _resolve(space, rng)
                for (path, _), value in zip(grids, combo):
                    _assign(config, path, value)
                yield config
        else:
            yield _resolve(space, rng)
