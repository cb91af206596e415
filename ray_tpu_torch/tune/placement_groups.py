"""PlacementGroupFactory: deferred placement-group requests.

Reference: ``python/ray/tune/execution/placement_groups.py`` — a
picklable description of the bundles a trial/trainer needs; the actual
placement group is created at schedule time.
"""

from __future__ import annotations

from typing import Dict, List


class PlacementGroupFactory:
    def __init__(self, bundles: List[Dict[str, float]],
                 strategy: str = "PACK"):
        if not bundles:
            raise ValueError("PlacementGroupFactory needs >= 1 bundle")
        # Drop empty bundles the way the reference does (head bundle may
        # legitimately be {} when the trainer itself needs no resources).
        self.bundles = [
            {k: float(v) for k, v in b.items() if v} for b in bundles]
        self.strategy = strategy

    @property
    def head_bundle_is_empty(self) -> bool:
        return not self.bundles[0]

    def required_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for b in self.bundles:
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        return total

    def __call__(self):
        """Create the placement group. An empty HEAD bundle is omitted
        (consumers must then use bundle offset 0 for workers); empty
        non-head bundles are invalid — dropping them would silently
        shift every later bundle index."""
        from ray_tpu_torch.util.placement_group import placement_group
        bundles = self.bundles[1:] if self.head_bundle_is_empty \
            else self.bundles
        if any(not b for b in bundles):
            raise ValueError(
                f"Empty non-head bundle in {self.bundles!r}")
        return placement_group(bundles, strategy=self.strategy)

    def __eq__(self, other):
        return (isinstance(other, PlacementGroupFactory)
                and self.bundles == other.bundles
                and self.strategy == other.strategy)

    def __repr__(self):
        return (f"PlacementGroupFactory(bundles={self.bundles!r}, "
                f"strategy={self.strategy!r})")
