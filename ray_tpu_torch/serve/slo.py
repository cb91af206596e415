"""Per-phase SLO budgets and the request-trace watchdog: the port's copy
of ``ray_tpu/serve/slo.py``.

Tail-based sampling (serve/request_trace.py) only ships 1-in-N fast
requests; this watchdog is what makes the *interesting* tail ship too.
Each serve replica evaluates three per-phase budgets as a request moves
through its pipeline:

- ``queue_s``            router enqueue -> engine admission wait
- ``ttft_s``             router enqueue -> first token (the user-facing
                         TTFT, queue wait included)
- ``inter_token_p99_s``  p99 of the request's inter-token gaps

The moment a budget trips, the request's trace flips to always-ship
(``trace.ship = True``) and ``serve_slo_violations_total{phase}`` is
incremented, so a p99-slow request is shipped even when the 1-in-N
sample missed it, with zero standing cost for requests that stay inside
budget.

Budgets come from a config object's ``slo_queue_s`` / ``slo_ttft_s`` /
``slo_inter_token_p99_s``; with none (the port has no runtime config
yet) the defaults below hold. A budget <= 0 is disabled.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.core.metric_defs import runtime_metrics
from ray_tpu_torch.serve.request_trace import (MAX_GAPS_PER_REQUEST,
                                               RequestTrace)

#: SLO phase labels (the metric's ``phase`` tag and the key under the
#: trace's ``slo`` dict — deliberately lowercase to read as budget
#: names, not span phases).
QUEUE = "queue"
TTFT = "ttft"
INTER_TOKEN_P99 = "inter_token_p99"


@dataclass(frozen=True)
class SLOBudget:
    """Per-phase latency budgets (seconds); <= 0 disables a budget."""
    queue_s: float = 1.0
    ttft_s: float = 5.0
    inter_token_p99_s: float = 1.0

    @classmethod
    def from_config(cls, config=None) -> "SLOBudget":
        if config is None:
            return cls()
        return cls(
            queue_s=float(getattr(config, "slo_queue_s", 1.0)),
            ttft_s=float(getattr(config, "slo_ttft_s", 5.0)),
            inter_token_p99_s=float(
                getattr(config, "slo_inter_token_p99_s", 1.0)))


def p99(values) -> float:
    """Nearest-rank p99 (== max for fewer than 100 samples, which is
    the right bias for short generations: one bad stall should trip)."""
    vs = sorted(values)
    if not vs:
        return 0.0
    return vs[max(0, math.ceil(0.99 * len(vs)) - 1)]


class SLOWatchdog:
    """Evaluates SLOBudget against one replica's requests. Stateless
    across requests (all state lives on the RequestTrace); one instance
    per engine."""

    def __init__(self, budget: Optional[SLOBudget] = None):
        self.budget = budget or SLOBudget()
        self._metrics = runtime_metrics()

    # ------------------------------------------------------ budget obs
    def observe_queue(self, trace: Optional[RequestTrace],
                      wait_s: float) -> bool:
        b = self.budget.queue_s
        if trace is None or b <= 0 or wait_s <= b:
            return False
        return self._trip(trace, QUEUE, wait_s, b)

    def observe_ttft(self, trace: Optional[RequestTrace],
                     ttft_s: float) -> bool:
        b = self.budget.ttft_s
        if trace is None or b <= 0 or ttft_s <= b:
            return False
        return self._trip(trace, TTFT, ttft_s, b)

    def observe_gap(self, trace: Optional[RequestTrace],
                    gap_s: float) -> bool:
        """Feed one inter-token gap; trips when the request's running
        p99 exceeds budget."""
        b = self.budget.inter_token_p99_s
        if trace is None or b <= 0:
            return False
        if len(trace.gaps) < MAX_GAPS_PER_REQUEST:
            trace.gaps.append(gap_s)
        if gap_s <= b:          # a p99 can only newly trip on a new max
            return False
        q = p99(trace.gaps)
        if q <= b:
            return False
        return self._trip(trace, INTER_TOKEN_P99, q, b)

    # ------------------------------------------------------------ trip
    def _trip(self, trace: RequestTrace, phase: str, value: float,
              budget: float) -> bool:
        first = phase not in trace.slo
        trace.slo[phase] = {"value": value, "budget": budget}
        trace.ship = True
        if first:
            self._metrics.serve_slo_violations.inc(tags={"phase": phase})
        return True
