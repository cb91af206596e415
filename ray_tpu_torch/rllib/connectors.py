"""Connector pipelines: composable obs/action transforms, a copy of
``ray_tpu/rllib/connectors.py`` (it has no device code).

Reference: ``rllib/connectors/`` (ConnectorV2 pipelines that sit
between env and module on the rollout side, and between dataset and
learner on the training side). Each connector is a pure callable over
numpy batches so runners stay picklable and the module keeps seeing
plain arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One stage; subclasses override __call__(batch_of_obs)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def state(self) -> Dict[str, Any]:
        """Serializable state, synced runner<->learner like weights."""
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            obs = c(obs)
        return obs

    def state(self) -> Dict[str, Any]:
        return {i: c.state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if i in state:
                c.set_state(state[i])


class FlattenObs(Connector):
    """Flatten any trailing obs dims to one feature axis (reference:
    connectors' flatten_observations)."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        return obs.reshape(obs.shape[0], -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(obs, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/variance normalization (reference:
    ``connectors/common/mean_std_filter.py`` — Welford accumulation,
    state synced across runners via the weight broadcast)."""

    def __init__(self, eps: float = 1e-8, clip: Optional[float] = 10.0):
        self.eps = eps
        self.clip = clip
        self._count = 0.0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:], np.float64)
            self._m2 = np.ones(obs.shape[1:], np.float64)
        for row in obs:  # batches are small on the rollout path
            self._count += 1.0
            delta = row - self._mean
            self._mean += delta / self._count
            self._m2 += delta * (row - self._mean)
        var = self._m2 / max(self._count, 2.0)
        out = (obs - self._mean) / np.sqrt(var + self.eps)
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)

    def state(self) -> Dict[str, Any]:
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class FrameStack(Connector):
    """Stack the last k observations along the feature axis (reference:
    connectors' framestacking for velocity-free envs)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: Optional[List[np.ndarray]] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        # copy: callers (EnvRunner) mutate their obs buffer in place —
        # storing references would alias every frame to the current obs
        obs = np.array(obs, np.float32, copy=True)
        if self._frames is None or self._frames[0].shape != obs.shape:
            self._frames = [obs] * self.k
        else:
            self._frames = self._frames[1:] + [obs]
        return np.concatenate(self._frames, axis=-1)
