"""Shared retry backoff: exponential growth with jitter, capped.

One implementation for every retry loop in the tree (reference: the
retry shape used across the GCS client, lease requests, and the cloud
provider transports — ``exponential_backoff.h`` and gcp/node.py's
retriable request path). Two jitter modes:

- ``full``: delay ~ U(0, min(cap, base * 2^attempt)). Best de-correlation
  under contention (AWS architecture blog's "full jitter"); used on the
  lease/reconnect path where many processes can retry against one
  controller at once.
- ``equal``: delay ~ d/2 + U(0, d/2) with d = min(cap, base * 2^attempt).
  Keeps a floor so tests can assert growth windows; used by the TPU API
  client (preserves its historical sleep envelope).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


def backoff_delay(attempt: int, base: float = 0.5, cap: float = 30.0,
                  jitter: str = "full",
                  rng: Optional[random.Random] = None) -> float:
    """Delay (seconds) for retry number ``attempt`` (0-based)."""
    r = rng if rng is not None else random
    d = min(cap, base * (2.0 ** max(0, attempt)))
    if jitter == "equal":
        return d * 0.5 + r.random() * d * 0.5
    if jitter == "none":
        return d
    return r.random() * d  # full jitter


class ExponentialBackoff:
    """Stateful backoff counter: ``next_delay()`` per failure,
    ``reset()`` on success. Thread-compatible for the single-writer
    patterns it serves (each instance is owned by one retry loop)."""

    def __init__(self, base: float = 0.5, cap: float = 30.0,
                 jitter: str = "full",
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self.jitter = jitter
        self._rng = rng if rng is not None else random.Random()
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def next_delay(self) -> float:
        d = backoff_delay(self._attempt, self.base, self.cap,
                          self.jitter, self._rng)
        self._attempt += 1
        return d

    def reset(self) -> None:
        self._attempt = 0

    def sleep(self, sleep_fn: Callable[[float], None] = time.sleep) -> float:
        """Draw the next delay and sleep it; returns the delay."""
        d = self.next_delay()
        sleep_fn(d)
        return d
