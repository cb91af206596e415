"""SLO-aware multi-tenant admission at the serve router.

The serving side of graceful degradation under train+serve colocation
(the cluster side is ``autoscaler/arbiter.py``): instead of letting an
overload wedge every replica's queue — TTFT for EVERY tenant then
collapses together — the router sheds over-budget and low-priority
traffic with a typed :class:`~ray_tpu_torch.exceptions.
AdmissionRejectedError` BEFORE the request reaches a replica, while
high-priority traffic keeps its TTFT bounded.

Two independent shed rules, checked in order:

1. **Per-tenant token budgets** (``tenant_budgets``: tenant →
   tokens/s, measured over a sliding ``budget_window_s`` window of
   ADMITTED token estimates). A tenant over its budget sheds with
   reason ``"over-budget"`` — unless the request's priority class is
   at/above ``budget_exempt_priority`` (default ``"high"``: paid SLO
   traffic bursts past its budget, the budget protects the fleet from
   the long tail).
2. **Priority shedding under overload.** When the fleet's engine
   gauges show saturation — the LEAST-loaded replica's queue depth is
   at/above ``queue_shed_depth`` or its TTFT EWMA at/above
   ``ttft_shed_s`` (if even the best replica is backed up, routing
   cannot help) — requests whose priority class is below
   ``shed_below_priority`` shed with reason ``"overload"``.

Priority classes are ``"low"`` < ``"normal"`` < ``"high"`` (ints
accepted too). Every shed increments
``serve_admission_rejected_total{tenant,priority}`` and records an
``ARBITER_REJECT`` flight event; admitted requests charge their token
estimate (``max_tokens`` of the call, else ``default_request_tokens``)
to the tenant's window.

Wired through ``handle.options(tenant=..., priority=...)`` and the
HTTP proxy's ``x-tenant`` / ``x-priority`` headers (shed → 429).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Union

from ray_tpu_torch.exceptions import AdmissionRejectedError

logger = logging.getLogger(__name__)

#: priority classes, lowest first; ints pass through unchanged
PRIORITY_CLASSES = {"low": 0, "normal": 1, "high": 2}


def priority_value(priority: Union[str, int, None]) -> int:
    if priority is None:
        return PRIORITY_CLASSES["normal"]
    if isinstance(priority, bool) or not isinstance(priority,
                                                    (str, int)):
        raise ValueError(f"priority must be a class name or int, "
                         f"got {priority!r}")
    if isinstance(priority, int):
        return priority
    try:
        return PRIORITY_CLASSES[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority class {priority!r} "
            f"(one of {sorted(PRIORITY_CLASSES)})") from None


def priority_name(priority: Union[str, int, None]) -> str:
    v = priority_value(priority)
    for name, val in PRIORITY_CLASSES.items():
        if val == v:
            return name
    return str(v)


@dataclasses.dataclass
class AdmissionPolicy:
    """Shed rules. ``None`` budgets = unlimited."""

    #: tenant -> admitted tokens/s over the sliding window
    tenant_budgets: Optional[Dict[str, float]] = None
    #: sliding window the budget rate is measured over
    budget_window_s: float = 10.0
    #: priority classes at/above this never budget-shed
    budget_exempt_priority: Union[str, int] = "high"
    #: best-replica queue depth at/above which overload shedding starts
    queue_shed_depth: float = 8.0
    #: best-replica TTFT EWMA (s) at/above which overload shedding
    #: starts
    ttft_shed_s: float = 4.0
    #: priority classes BELOW this shed under overload
    shed_below_priority: Union[str, int] = "normal"
    #: token estimate for requests that don't carry ``max_tokens``
    default_request_tokens: int = 32

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe round-trip form (the dashboard config endpoint's
        wire format)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AdmissionPolicy":
        """Build + validate a policy from a config payload (the
        ``POST /api/v0/admission/policy`` body). Unknown keys are a
        hard error — a typo'd knob must not silently admit
        everything."""
        if not isinstance(d, dict):
            raise ValueError(
                f"admission policy must be an object, got {type(d)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown admission policy keys {sorted(unknown)} "
                f"(known: {sorted(known)})")
        p = cls(**d)
        if p.budget_window_s <= 0:
            raise ValueError("budget_window_s must be > 0")
        if p.default_request_tokens <= 0:
            raise ValueError("default_request_tokens must be > 0")
        if p.tenant_budgets is not None:
            if not isinstance(p.tenant_budgets, dict):
                raise ValueError("tenant_budgets must be a mapping of "
                                 "tenant -> tokens/s")
            for t, b in p.tenant_budgets.items():
                if not isinstance(b, (int, float)) or \
                        isinstance(b, bool) or b < 0:
                    raise ValueError(
                        f"budget for tenant {t!r} must be a "
                        f"non-negative number, got {b!r}")
        # both priority knobs must resolve now, not at admit time
        priority_value(p.budget_exempt_priority)
        priority_value(p.shed_below_priority)
        return p


class AdmissionController:
    """One per router (shared across ``options()`` copies, like the
    router itself, so budget accounting spans them)."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None,
                 recorder=None,
                 now_fn=time.monotonic):
        self.policy = policy or AdmissionPolicy()
        self._recorder = recorder
        self._now = now_fn
        # tenant -> deque[(ts, tokens)] of admitted estimates
        self._spend: Dict[str, collections.deque] = {}
        self.admitted = 0
        self.rejected = 0
        #: seq of the last policy applied via the config plane
        self.policy_seq = 0

    def set_policy(self, policy: AdmissionPolicy,
                   seq: Optional[int] = None) -> None:
        """Swap the shed rules in place, keeping the per-tenant spend
        windows — a budget refresh must not amnesty tenants that are
        already over their (new) budget."""
        self.policy = policy
        if seq is not None:
            self.policy_seq = seq

    # ------------------------------------------------------- budgets
    def _rate(self, tenant: str, now: float) -> float:
        window = self.policy.budget_window_s
        q = self._spend.get(tenant)
        if not q:
            return 0.0
        while q and now - q[0][0] > window:
            q.popleft()
        return sum(t for _, t in q) / window if q else 0.0

    def _charge(self, tenant: str, tokens: float, now: float) -> None:
        self._spend.setdefault(
            tenant, collections.deque()).append((now, tokens))

    # ------------------------------------------------------ overload
    @staticmethod
    def _best_replica_load(gauges: Dict[Any, Dict[str, Any]]):
        """(min queue depth, min TTFT EWMA) across fresh replica
        gauges — the least-loaded replica decides overload: if even it
        is backed up, no routing choice can absorb the request."""
        depths = [g.get("queue_depth") for g in gauges.values()
                  if g.get("queue_depth") is not None]
        ttfts = [g.get("ttft_ewma_s") for g in gauges.values()
                 if g.get("ttft_ewma_s") is not None]
        return (min(depths) if depths else 0.0,
                min(ttfts) if ttfts else 0.0)

    def overloaded(self, gauges: Dict[Any, Dict[str, Any]]) -> bool:
        q, ttft = self._best_replica_load(gauges)
        return q >= self.policy.queue_shed_depth or \
            ttft >= self.policy.ttft_shed_s

    # --------------------------------------------------------- admit
    def admit(self, tenant: Optional[str],
              priority: Union[str, int, None],
              gauges: Dict[Any, Dict[str, Any]],
              tokens: Optional[float] = None,
              request_id: Optional[str] = None) -> None:
        """Admit (charging the tenant's budget window) or raise
        :class:`AdmissionRejectedError`. ``request_id`` is the trace
        identity minted by the router; sheds stamp it into the error,
        the ARBITER_REJECT event, and (at the caller) the SHED span so
        a 429 body can be joined against its waterfall."""
        tenant = tenant or "default"
        prio = priority_value(priority)
        pname = priority_name(priority)
        tokens = float(tokens if tokens is not None
                       else self.policy.default_request_tokens)
        now = self._now()
        budgets = self.policy.tenant_budgets or {}
        budget = budgets.get(tenant)
        if budget is not None and \
                prio < priority_value(self.policy.
                                      budget_exempt_priority):
            rate = self._rate(tenant, now)
            if rate + tokens / self.policy.budget_window_s > budget:
                self._reject(tenant, pname, "over-budget",
                             f"{rate:.1f} tok/s against a "
                             f"{budget:.1f} tok/s budget",
                             request_id=request_id)
        if prio < priority_value(self.policy.shed_below_priority) \
                and self.overloaded(gauges):
            q, ttft = self._best_replica_load(gauges)
            self._reject(tenant, pname, "overload",
                         f"best replica queue {q:.0f}, "
                         f"ttft {ttft:.2f}s",
                         request_id=request_id)
        self._charge(tenant, tokens, now)
        self.admitted += 1

    def _reject(self, tenant: str, priority: str, reason: str,
                detail: str, request_id: Optional[str] = None) -> None:
        self.rejected += 1
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            runtime_metrics().admission_rejected.inc(
                tags={"tenant": tenant, "priority": priority})
        except Exception:
            pass
        r = self._recorder
        if r is None:
            try:
                from ray_tpu_torch.core.global_state import try_global_worker
                r = getattr(try_global_worker(), "recorder", None)
            except Exception:
                r = None
        if r is not None:
            try:
                r.record("ARBITER_REJECT", tenant=tenant,
                         priority=priority, reason=reason,
                         request_id=request_id or "")
            except Exception:
                pass
        raise AdmissionRejectedError(tenant=tenant, priority=priority,
                                     reason=reason, detail=detail,
                                     request_id=request_id or "")

    def stats(self) -> Dict[str, Any]:
        now = self._now()
        return {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "tenant_rates": {t: round(self._rate(t, now), 2)
                             for t in list(self._spend)},
        }
