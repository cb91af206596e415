"""Cluster-level slice arbitration between a serve fleet and an
elastic training job. The port's copy of ``ray_tpu/autoscaler/arbiter.py``:
its gauges come from the port's metrics plane (an engine's
``queue_depth`` and TTFT, a ``TrainStepBundle``'s ``train_tokens_per_s``),
and its slices from the port's :class:`SliceManager`, whose hosts count
their CUDA devices as ``GPU``.

The :class:`SliceArbiter` is a priority/fair-share policy loop that
runs on the head next to the :class:`~ray_tpu_torch.autoscaler.slices.
SliceManager` (under the same ``AutoscalerMonitor`` — construct with
``drive_manager=True`` and hand the arbiter to the monitor, and each
tick reconciles slices first, then arbitrates). It reads fleet gauges
from the metrics plane — engine queue depth, TTFT p99, decode
occupancy vs training tokens/s — and moves whole slices between the
two workloads:

- **Sustained serve pressure** (queue depth or p99 TTFT above the
  policy's high-water marks for ``sustain_s``) → the arbiter drains
  the LOWEST-priority training slice (``drain_slice(sid,
  "arbiter-preempt")``). The ``ElasticTrainer`` observes the same
  multi-subscriber drain notice and re-lowers onto the survivors
  (≤ 1 step lost); the freed hosts serve the spike.
- **Pressure ebbs** past the hysteresis low-water marks for ``ebb_s``
  → the arbiter re-acquires a slice of the same type, hands the claim
  back to the training job, and fires its ``on_return`` subscribers so
  the trainer can :meth:`~ray_tpu_torch.parallel.elastic.ElasticTrainer.
  regrow` the plan.

Ownership is explicit: workloads (the job layer, a bench, a test)
``claim()`` their slices with an owner name, a kind (``train`` /
``serve``) and an integer priority — higher wins, ties borrow the most
recently claimed slice first. The arbiter never preempts serve claims
and never drops the training job below ``min_train_slices``.

Every decision is observable: ``ARBITER_PREEMPT`` / ``ARBITER_RETURN``
flight events carry ``dur_s`` (the sustained-pressure window and the
whole borrow window respectively — both render as Perfetto duration
slices on ``/timeline``) and the
``autoscaler_arbiter_preemptions_total{reason}`` /
``autoscaler_arbiter_returns_total{reason}`` counters feed the
metrics plane. :meth:`status` returns the live per-slice ownership
rows the dashboard's ``/api/v0/arbiter`` route and ``cli job list``
print.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.slices import RELEASED, UP

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ArbiterPolicy:
    """Knobs of the pressure detector and the fair-share rules.

    Pressure is declared when ANY high-water mark is crossed and held
    for ``sustain_s``; calm requires EVERY low-water mark for
    ``ebb_s`` (hysteresis — the gap between the two marks is the
    flap-damping band)."""

    #: per-replica engine queue depth above which serve is under
    #: pressure (the engine admits but requests wait for slots)
    queue_high: float = 4.0
    #: fleet p99 TTFT (ms) above which serve is under pressure
    ttft_p99_high_ms: float = 2000.0
    #: queue depth at/below which pressure has ebbed
    queue_low: float = 1.0
    #: p99 TTFT (ms) at/below which pressure has ebbed
    ttft_p99_low_ms: float = 1000.0
    #: pressure must hold this long before a preemption fires
    sustain_s: float = 2.0
    #: calm must hold this long before a borrowed slice returns
    ebb_s: float = 4.0
    #: training never drops below this many UP/REQUESTED slices
    min_train_slices: int = 0
    #: at most this many slices borrowed from training at once
    max_borrowed: int = 1
    #: metrics-plane window fed to ``fleet_summary``
    window_s: float = 30.0


@dataclasses.dataclass
class SliceClaim:
    """One workload's ownership of one slice."""

    slice_id: str
    owner: str
    kind: str              # "train" | "serve"
    priority: int          # higher = more important
    claimed_at: float = 0.0


@dataclasses.dataclass
class _Borrow:
    """A train slice the arbiter took for serve, awaiting return."""

    claim: SliceClaim
    slice_type: str
    preempted_at: float
    reason: str


class SliceArbiter:
    """See module docstring. ``update()`` is the whole contract — an
    ``AutoscalerMonitor`` drives it like any autoscaler."""

    def __init__(self, slice_manager,
                 policy: Optional[ArbiterPolicy] = None,
                 gauges_fn: Optional[Callable[[], Dict]] = None,
                 recorder=None,
                 drive_manager: bool = False,
                 now_fn: Callable[[], float] = time.monotonic):
        self.manager = slice_manager
        self.policy = policy or ArbiterPolicy()
        self._gauges_fn = gauges_fn
        self._recorder = recorder if recorder is not None \
            else getattr(slice_manager, "_recorder", None)
        self._drive_manager = drive_manager
        self._now = now_fn
        self.claims: Dict[str, SliceClaim] = {}
        self.borrowed: List[_Borrow] = []
        self._pressure_since: Optional[float] = None
        self._pressure_reason: str = ""
        self._calm_since: Optional[float] = None
        self._on_return: List[Callable[[Dict], None]] = []
        self.preemptions = 0
        self.returns = 0
        self._last_gauges: Dict[str, Any] = {}

    # ------------------------------------------------------ ownership
    def claim(self, slice_id: str, owner: str, kind: str,
              priority: int = 0) -> SliceClaim:
        """Record that ``owner`` runs on ``slice_id``. ``kind`` is
        ``"train"`` (preemptible by policy) or ``"serve"`` (never
        preempted)."""
        if kind not in ("train", "serve"):
            raise ValueError(f"unknown claim kind {kind!r}")
        c = SliceClaim(slice_id=slice_id, owner=owner, kind=kind,
                       priority=priority, claimed_at=self._now())
        self.claims[slice_id] = c
        return c

    def release_claim(self, slice_id: str) -> None:
        self.claims.pop(slice_id, None)

    def register_on_return(self, callback) -> Any:
        """``callback(info)`` fires after a borrowed slice is handed
        back to training; ``info`` carries ``slice_id`` (the NEW
        slice), ``owner``, ``type`` and ``borrowed_s``. Returns the
        callback (decorator friendly)."""
        self._on_return.append(callback)
        return callback

    def unregister_on_return(self, callback) -> None:
        try:
            self._on_return.remove(callback)
        except ValueError:
            pass

    # -------------------------------------------------------- gauges
    def _gauges(self) -> Dict[str, Any]:
        """Serve-pressure signals, normalized. Sources, in order: an
        injected ``gauges_fn`` (tests, the colocate bench), the
        controller's in-process metrics plane (``fleet_summary`` rows),
        or — when the arbiter runs in a driver/monitor process with no
        direct controller reference — the live metrics plane over the
        state API (``fleet_metrics`` query), so an
        ``AutoscalerMonitor``-driven arbiter needs no injection at
        all."""
        if self._gauges_fn is not None:
            raw = self._gauges_fn() or {}
        else:
            plane = getattr(getattr(self.manager, "controller", None),
                            "metrics_plane", None)
            if plane is not None:
                raw = plane.fleet_summary(
                    window_s=self.policy.window_s)
            else:
                try:
                    from ray_tpu_torch.util.state import fleet_metrics
                    raw = fleet_metrics(
                        window_s=self.policy.window_s) or {}
                except Exception:
                    return {}
        if "rows" in raw:        # fleet_summary payload → normalize
            rows = raw.get("rows") or []
            depths = [r["queue_depth"] for r in rows
                      if r.get("queue_depth") is not None]
            p99s = [r["ttft_p99_ms"] for r in rows
                    if r.get("ttft_p99_ms") is not None]
            fleet = raw.get("fleet") or {}
            return {
                "queue_depth": max(depths) if depths else 0.0,
                "ttft_p99_ms": max(p99s) if p99s else 0.0,
                "serve_tokens_per_s": fleet.get("tokens_per_s", 0.0),
                "train_tokens_per_s": fleet.get(
                    "train_tokens_per_s", 0.0),
            }
        return raw

    def _classify(self, g: Dict[str, Any]):
        """(pressure?, calm?, reason) from one gauge sample."""
        q = float(g.get("queue_depth") or 0.0)
        p99 = float(g.get("ttft_p99_ms") or 0.0)
        pol = self.policy
        if q >= pol.queue_high:
            return True, False, "queue-depth"
        if p99 >= pol.ttft_p99_high_ms:
            return True, False, "ttft-p99"
        calm = q <= pol.queue_low and p99 <= pol.ttft_p99_low_ms
        return False, calm, ""

    # -------------------------------------------------------- policy
    def _train_claims_up(self) -> List[SliceClaim]:
        out = []
        for sid, c in self.claims.items():
            if c.kind != "train":
                continue
            info = self.manager.slices.get(sid)
            if info is not None and info.state == UP:
                out.append(c)
        return out

    def _pick_victim(self) -> Optional[SliceClaim]:
        """Lowest priority first; ties borrow the most recently
        claimed slice (the training job keeps its oldest, warmest
        capacity)."""
        candidates = self._train_claims_up()
        if len(candidates) <= self.policy.min_train_slices:
            return None
        candidates.sort(key=lambda c: (c.priority, -c.claimed_at))
        return candidates[0]

    def _record(self, ev: str, **data) -> None:
        r = self._recorder
        if r is None:
            return
        try:
            r.record(ev, **data)
        except Exception:
            pass

    def _count(self, counter: str, **tags) -> None:
        try:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            getattr(runtime_metrics(), counter).inc(tags=tags)
        except Exception:
            pass

    def _preempt(self, victim: SliceClaim, reason: str,
                 sustained_s: float) -> None:
        info = self.manager.slices.get(victim.slice_id)
        slice_type = info.type if info is not None else ""
        now = self._now()
        self.manager.drain_slice(victim.slice_id,
                                 "arbiter-preempt")
        self.claims.pop(victim.slice_id, None)
        self.borrowed.append(_Borrow(
            claim=victim, slice_type=slice_type,
            preempted_at=now, reason=reason))
        self.preemptions += 1
        self._record("ARBITER_PREEMPT", slice=victim.slice_id,
                     reason=reason, owner=victim.owner,
                     priority=victim.priority,
                     dur_s=round(sustained_s, 6))
        self._count("arbiter_preemptions", reason=reason)
        logger.warning(
            "arbiter: preempting train slice %s of %s (prio %d) — "
            "%s sustained %.1fs", victim.slice_id, victim.owner,
            victim.priority, reason, sustained_s)

    def _return_one(self) -> bool:
        """Hand ONE borrowed slice back to training; False on
        provider stockout (retried next tick, the borrow stays)."""
        borrow = self.borrowed[0]
        sid = self.manager.acquire_slice(borrow.slice_type)
        if sid is None:
            return False
        self.borrowed.pop(0)
        c = borrow.claim
        self.claim(sid, c.owner, "train", c.priority)
        borrowed_s = self._now() - borrow.preempted_at
        self.returns += 1
        self._record("ARBITER_RETURN", slice=sid, owner=c.owner,
                     reason="pressure-ebbed",
                     dur_s=round(borrowed_s, 6))
        self._count("arbiter_returns", reason="pressure-ebbed")
        logger.info("arbiter: returned slice %s to %s after %.1fs "
                    "borrow", sid, c.owner, borrowed_s)
        info = {"slice_id": sid, "owner": c.owner,
                "type": borrow.slice_type,
                "borrowed_s": round(borrowed_s, 6)}
        for cb in list(self._on_return):
            if cb not in self._on_return:
                continue
            try:
                cb(info)
            except Exception:
                logger.exception("on_return callback failed for %s",
                                 sid)
        return True

    # --------------------------------------------------------- update
    def update(self) -> Dict[str, Any]:
        """One arbitration tick (monitor-driven)."""
        if self._drive_manager:
            try:
                self.manager.update()
            except Exception:
                logger.exception("arbiter: manager reconcile failed")
        # drop claims whose slice is gone (released under us)
        for sid in list(self.claims):
            info = self.manager.slices.get(sid)
            if info is not None and info.state == RELEASED:
                self.claims.pop(sid, None)
        g = self._gauges()
        self._last_gauges = dict(g)
        pressure, calm, reason = self._classify(g)
        now = self._now()
        actions: List[str] = []

        if pressure:
            self._calm_since = None
            if self._pressure_since is None:
                self._pressure_since = now
                self._pressure_reason = reason
            sustained = now - self._pressure_since
            if sustained >= self.policy.sustain_s and \
                    len(self.borrowed) < self.policy.max_borrowed:
                victim = self._pick_victim()
                if victim is not None:
                    self._preempt(victim, self._pressure_reason
                                  or reason, sustained)
                    actions.append(f"preempt:{victim.slice_id}")
                    # a further preemption needs a FRESH sustained
                    # window — one slice per pressure episode
                    self._pressure_since = now
        else:
            self._pressure_since = None
            if calm:
                if self._calm_since is None:
                    self._calm_since = now
                if self.borrowed and \
                        now - self._calm_since >= self.policy.ebb_s:
                    if self._return_one():
                        actions.append("return")
            else:
                self._calm_since = None
        return {"pressure": pressure, "calm": calm,
                "reason": reason or self._pressure_reason,
                "borrowed": len(self.borrowed), "actions": actions}

    # --------------------------------------------------------- status
    def status(self) -> Dict[str, Any]:
        """Live ownership rows for the dashboard / ``cli job list``:
        who owns which slices and why."""
        rows = []
        for sid, c in sorted(self.claims.items()):
            info = self.manager.slices.get(sid)
            rows.append({
                "slice_id": sid, "owner": c.owner, "kind": c.kind,
                "priority": c.priority,
                "state": info.state if info is not None else "?",
                "why": "claimed",
            })
        for b in self.borrowed:
            info = self.manager.slices.get(b.claim.slice_id)
            state = info.state if info is not None else "RELEASED"
            rows.append({
                "slice_id": b.claim.slice_id, "owner": b.claim.owner,
                "kind": "train", "priority": b.claim.priority,
                "state": state,
                "why": f"borrowed-by-serve ({b.reason})",
            })
        return {
            "rows": rows,
            "pressure": self._pressure_since is not None,
            "pressure_reason": self._pressure_reason,
            "borrowed": len(self.borrowed),
            "preemptions": self.preemptions,
            "returns": self.returns,
            "gauges": dict(self._last_gauges),
            "policy": dataclasses.asdict(self.policy),
        }

    def stats(self) -> Dict[str, Any]:
        return {"preemptions": self.preemptions,
                "returns": self.returns,
                "borrowed": len(self.borrowed),
                "claims": len(self.claims)}
