"""Per-request tracing for the serve path.

The request is a first-class traced object: a ``request_id`` (minted by
a router, or locally at ``submit``) and the router's annotations arrive
in the engine's ``trace_ctx``, and the engine materialises the request's
life into phase spans:

=============  =====================================================
phase          meaning
=============  =====================================================
QUEUED         router enqueue -> engine admission (a decode slot won)
ADMITTED       slot assignment incl. prefix-cache match / CoW forks
PREFILL        one chunked-prefill step (per chunk)
KV_SHIP        disagg hand-off: finished prefill KV blocks in flight
               from the prefill replica to the chosen decode replica
KV_ADOPT       disagg hand-off: decode replica adopting shipped blocks
               into its pool + radix trie (bytes/blocks/wire in attrs)
SPEC_VERIFY    one speculative verify step (drafted/accepted counts)
DECODE         a per-N-token tick of batched decode
WEIGHT_SWAP    an in-flight weight refresh overlapping this request
FIRST_TOKEN    instant: first emitted token (TTFT anchor)
DONE           terminal: completed normally
FAILED         terminal: typed error (named in ``attrs.error``)
SHED           terminal: rejected by admission before any replica
=============  =====================================================

Spans are recorded locally in a bounded per-request buffer at
flight-recorder cost (one dict and an append). Tail-based sampling keeps
the hot path's cost bounded: every request records, but only slow (an
SLO budget tripped, serve/slo.py), failed or shed requests and a
deterministic 1-in-N sample ship; fast unsampled requests are recorded
and discarded locally, shipping zero bytes.

The port's copy of ``ray_tpu/serve/request_trace.py``. The JAX package
ships a trace as a REQUEST_SPANS message to its controller when a
runtime is attached, and into the tracer's local deque otherwise; the
port has no runtime yet, so the local deque
(``RequestTracer.shipped_local``) is where a shipped trace goes, unless
the tracer was given a ``send`` callable. :class:`RequestTraceStore` is
the controller-side store that merges shipped parts into waterfalls.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.metric_defs import runtime_metrics

# Canonical phase names. Terminal phases close the waterfall.
QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
PREFILL = "PREFILL"
KV_SHIP = "KV_SHIP"
KV_ADOPT = "KV_ADOPT"
SPEC_VERIFY = "SPEC_VERIFY"
DECODE = "DECODE"
WEIGHT_SWAP = "WEIGHT_SWAP"
FIRST_TOKEN = "FIRST_TOKEN"
DONE = "DONE"
FAILED = "FAILED"
SHED = "SHED"

TERMINAL_PHASES = frozenset({DONE, FAILED, SHED})

#: Render/aggregation order for waterfalls and per-phase breakdowns.
PHASE_ORDER = (QUEUED, ADMITTED, PREFILL, KV_SHIP, KV_ADOPT,
               SPEC_VERIFY, DECODE, WEIGHT_SWAP, FIRST_TOKEN, DONE,
               FAILED, SHED)

#: Cap on spans buffered per request: a pathological 100k-token decode
#: must not make its own trace unbounded. Oldest non-terminal spans are
#: dropped first; the drop is counted in the trace meta.
MAX_SPANS_PER_REQUEST = 512

#: Cap on the inter-token gap reservoir the SLO watchdog evaluates.
MAX_GAPS_PER_REQUEST = 1024


def new_request_id() -> str:
    return "req-" + uuid.uuid4().hex[:16]


class RequestTrace:
    """Span buffer for one request. Cheap by construction: recording a
    span is one dict build + one append under no lock (each trace is
    owned by the single thread driving that request's phase)."""

    __slots__ = ("request_id", "part", "sampled", "ship", "spans",
                 "meta", "slo", "gaps", "status", "t_begin", "dropped")

    def __init__(self, request_id: str, part: str = "engine",
                 sampled: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        self.request_id = request_id
        self.part = part
        self.sampled = bool(sampled)
        #: flips True the moment an SLO budget trips or the request
        #: fails — tail sampling's "always ship" escape hatch.
        self.ship = bool(sampled)
        self.spans: List[Dict[str, Any]] = []
        self.meta: Dict[str, Any] = dict(meta or {})
        self.slo: Dict[str, Dict[str, float]] = {}
        self.gaps: List[float] = []
        self.status: Optional[str] = None
        self.t_begin = time.time()
        self.dropped = 0

    # ------------------------------------------------------- recording
    def span(self, phase: str, t0: float, t1: Optional[float] = None,
             **attrs: Any) -> None:
        """Record one phase span (wall-clock seconds; ``t1=None`` makes
        an instant). Must stay O(1) and allocation-light: it runs on the
        engine's step thread for every traced phase."""
        if t1 is None:
            t1 = t0
        elif t1 < t0:
            t1 = t0
        s: Dict[str, Any] = {"request_id": self.request_id,
                             "phase": phase, "t0": t0, "t1": t1}
        if attrs:
            s["attrs"] = attrs
        if len(self.spans) >= MAX_SPANS_PER_REQUEST:
            # drop the oldest non-terminal span; keep the count honest
            self.spans.pop(0)
            self.dropped += 1
        self.spans.append(s)
        if phase in TERMINAL_PHASES:
            self.status = phase
            if phase != DONE:          # FAILED / SHED always ship
                self.ship = True

    def event(self, phase: str, t: Optional[float] = None,
              **attrs: Any) -> None:
        """Instant span (FIRST_TOKEN and friends)."""
        self.span(phase, time.time() if t is None else t, None, **attrs)


class RequestTracer:
    """Per-process tracer: hands out ``RequestTrace`` buffers, applies
    the deterministic 1-in-N baseline sample, and ships finished traces
    that earned it. A bounded ring of recently finished traces is kept
    locally (shipped or not) so a postmortem can look at requests that
    tail sampling discarded."""

    def __init__(self, config=None, part: str = "engine",
                 send=None, sample_n: Optional[int] = None):
        self.part = part
        self.enabled = True
        n = 100
        if config is not None:
            self.enabled = bool(
                getattr(config, "enable_request_trace", True))
            n = int(getattr(config, "trace_sample_n", 100))
        if sample_n is not None:
            n = int(sample_n)
        self.sample_n = n
        self._send = send
        self._count = itertools.count()
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        #: recently finished traces (local ring; postmortem aid)
        self.recent: collections.deque = collections.deque(maxlen=128)
        #: payloads shipped when no runtime is attached (unit tests)
        self.shipped_local: collections.deque = collections.deque(
            maxlen=32)

    # ------------------------------------------------------- lifecycle
    def begin(self, request_id: Optional[str] = None,
              sampled: Optional[bool] = None,
              meta: Optional[Dict[str, Any]] = None
              ) -> Optional[RequestTrace]:
        """Start a trace, or return None when tracing is disabled (all
        call sites treat a None trace as a no-op)."""
        if not self.enabled:
            return None
        if sampled is None:
            n = self.sample_n
            sampled = n > 0 and (next(self._count) % n) == 0
        return RequestTrace(request_id or new_request_id(),
                            part=self.part, sampled=bool(sampled),
                            meta=meta)

    def finish(self, trace: Optional[RequestTrace],
               status: Optional[str] = None,
               err: Optional[BaseException] = None) -> bool:
        """Close a trace; ship it iff sampled, SLO-tripped, or
        failed/shed. Returns whether spans were shipped."""
        if trace is None:
            return False
        if err is not None and trace.status not in TERMINAL_PHASES:
            trace.span(FAILED, time.time(),
                       error=type(err).__name__, detail=str(err)[:200])
        elif status is not None and trace.status is None:
            trace.span(status, time.time())
        self.recent.append(trace)
        if not trace.ship:
            return False
        return self._ship(trace)

    # -------------------------------------------------------- shipping
    def _ship(self, trace: RequestTrace) -> bool:
        with self._lock:
            seq = next(self._seq)
        payload = {
            "request_id": trace.request_id,
            "part": trace.part,
            # the origin process's recorder label (no runtime: none)
            "proc": "?",
            "seq": seq,
            "ts": time.time(),
            "status": trace.status,
            "sampled": trace.sampled,
            "slo": trace.slo,
            "meta": trace.meta,
            "dropped": trace.dropped,
            "spans": trace.spans,
        }
        runtime_metrics().request_spans_shipped.inc()
        sender = self._send
        if sender is not None:
            try:
                sender(payload)
                return True
            except Exception:
                return False
        return _default_send(payload, self.shipped_local)


def _default_send(payload: Dict[str, Any], fallback) -> bool:
    """Ship hook without a ``send`` callable: the port has no runtime to
    ship to, so the payload lands in the tracer's local deque (where the
    JAX package puts it when no runtime is attached). Returns False: the
    trace did not leave the process."""
    fallback.append(payload)
    return False


# ---------------------------------------------------------------------
# the store shipped traces are merged in
# ---------------------------------------------------------------------

class RequestTraceStore:
    """Store of shipped request traces (the JAX package keeps one on its
    controller). Internally locked. Exactly-once-effect: it dedups by
    ``(part, seq)`` per request, so a duplicate delivery cannot double a
    waterfall. Bounded drop-oldest by finished request."""

    def __init__(self, max_requests: int = 512):
        self.max_requests = int(max_requests)
        self._lock = threading.Lock()
        self._reqs: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        self.ingested = 0
        self.deduped = 0

    # ------------------------------------------------------- ingestion
    def ingest(self, payload: Dict[str, Any]) -> bool:
        rid = payload.get("request_id")
        if not rid:
            return False
        key = (payload.get("part", "?"), payload.get("seq", 0))
        with self._lock:
            ent = self._reqs.get(rid)
            if ent is None:
                ent = {"request_id": rid, "parts": set(), "spans": [],
                       "status": None, "slo": {}, "meta": {},
                       "procs": {}, "dropped": 0,
                       "ts": payload.get("ts", 0.0)}
                self._reqs[rid] = ent
                while len(self._reqs) > self.max_requests:
                    self._reqs.popitem(last=False)
            if key in ent["parts"]:
                self.deduped += 1
                return False
            ent["parts"].add(key)
            if payload.get("proc"):
                ent["procs"][payload.get("part", "?")] = payload["proc"]
            ent["spans"].extend(payload.get("spans") or [])
            ent["slo"].update(payload.get("slo") or {})
            ent["meta"].update(payload.get("meta") or {})
            ent["dropped"] += int(payload.get("dropped", 0))
            ent["ts"] = max(ent["ts"], payload.get("ts", 0.0))
            status = payload.get("status")
            # a terminal status from any part wins; FAILED/SHED beats
            # DONE (the failing part saw the request's true end)
            if status and (ent["status"] is None
                           or ent["status"] == DONE):
                ent["status"] = status
            self.ingested += 1
            self._reqs.move_to_end(rid)
            return True

    # --------------------------------------------------------- queries
    @staticmethod
    def _phase_breakdown(spans: List[Dict[str, Any]]
                         ) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for s in spans:
            ph = s.get("phase", "?")
            d = out.setdefault(ph, {"count": 0, "dur_s": 0.0})
            d["count"] += 1
            d["dur_s"] += max(0.0, s.get("t1", 0.0) - s.get("t0", 0.0))
        return out

    @staticmethod
    def _sorted_spans(ent: Dict[str, Any]) -> List[Dict[str, Any]]:
        # sort by start time → monotone phase timestamps in the
        # waterfall even when parts shipped out of order; clamp each
        # span's end to its start (cross-process clock skew must never
        # render a negative-width slice)
        spans = sorted(ent["spans"],
                       key=lambda s: (s.get("t0", 0.0),
                                      s.get("t1", 0.0)))
        for s in spans:
            if s.get("t1", 0.0) < s.get("t0", 0.0):
                s["t1"] = s["t0"]
        return spans

    def rows(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Recent traced requests, newest first, with per-phase
        breakdown (the /api/v0/requests listing)."""
        with self._lock:
            ents = list(self._reqs.values())[-int(limit):]
        rows = []
        for ent in reversed(ents):
            spans = self._sorted_spans(ent)
            t0 = spans[0]["t0"] if spans else 0.0
            t1 = max((s["t1"] for s in spans), default=t0)
            rows.append({
                "request_id": ent["request_id"],
                "status": ent["status"],
                "ts": ent["ts"],
                "dur_s": max(0.0, t1 - t0),
                "n_spans": len(spans),
                "slo": ent["slo"],
                "phases": self._phase_breakdown(spans),
            })
        return rows

    def waterfall(self, request_id: str) -> Optional[Dict[str, Any]]:
        """Full span list for one request, spans sorted by start."""
        with self._lock:
            ent = self._reqs.get(request_id)
            if ent is None:
                return None
        spans = self._sorted_spans(ent)
        t0 = spans[0]["t0"] if spans else 0.0
        t1 = max((s["t1"] for s in spans), default=t0)
        return {
            "request_id": ent["request_id"],
            "status": ent["status"],
            "ts": ent["ts"],
            "dur_s": max(0.0, t1 - t0),
            "slo": ent["slo"],
            "meta": ent["meta"],
            "procs": dict(ent.get("procs") or {}),
            "dropped": ent["dropped"],
            "phases": self._phase_breakdown(spans),
            "spans": spans,
        }

    def slowest(self) -> Optional[Dict[str, Any]]:
        """Waterfall of the slowest captured request (chaos postmortem
        sidecar)."""
        with self._lock:
            rids = list(self._reqs.keys())
        best, best_dur = None, -1.0
        for rid in rids:
            w = self.waterfall(rid)
            if w is not None and w["dur_s"] > best_dur:
                best, best_dur = w, w["dur_s"]
        return best
