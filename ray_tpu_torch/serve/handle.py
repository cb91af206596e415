"""DeploymentHandle: client-side router — gauge-aware by default.

Reference: ``python/ray/serve/handle.py`` + ``_private/router.py:259``
and ``replica_scheduler/pow_2_scheduler.py:44``. Three routing
policies (``options(routing_policy=...)``, default ``"gauge"``):

- ``"gauge"`` — route on the per-replica ENGINE gauges (free decode
  slots, free KV blocks, queue depth, TTFT EWMA from
  ``Replica.stats()``), probed asynchronously and cached for
  ``gauge_refresh_s``; replicas without engine gauges (plain
  deployments) fall back to power-of-two-choices. When direct probes
  go quiet the router backfills from the controller's fleet metrics
  plane (``/api/v0/metrics/fleet``), matching rows to replicas by pid.
- ``"pow2"`` — classic power-of-two-choices on the router's own
  outstanding-refs count per replica plus live streams.
- ``"round_robin"`` — cycle the membership list (the pre-gauge
  baseline; ``bench_serve --fleet`` measures gauge routing against it).

``options(session_id=...)`` adds **session affinity**: every call with
the same session id lands on the same replica while it lives, so a
multi-turn conversation's shared prefix KV blocks are HIT in that
replica's radix cache instead of re-prefetched cold elsewhere.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch


def gauge_score(g: Dict[str, Any]) -> float:
    """Desirability of a replica from its engine gauges (higher is
    better): capacity to start decoding now (free slots), room for new
    sequences' KV (free blocks), minus admission backlog and the
    latency users are currently seeing (TTFT EWMA)."""
    free_slots = g.get("free_slots") or 0
    total_slots = free_slots + (g.get("active_slots") or 0)
    slots_frac = free_slots / total_slots if total_slots else 0.0
    total_blocks = g.get("total_blocks") or 0
    blocks_frac = (g.get("free_blocks") or 0) / total_blocks \
        if total_blocks else 0.0
    queue = g.get("queue_depth") or 0
    ttft = g.get("ttft_ewma_s") or 0.0
    return 2.0 * slots_frac + blocks_frac - 0.5 * queue \
        - min(float(ttft), 2.0)


def _ship_failure(tracer, trace, err: BaseException) -> None:
    """Client-observed terminal failure: the replica (possibly dead —
    SIGKILL mid-decode) cannot ship this request's trace, so the
    router part does, ending it in a FAILED span naming the typed
    error. No-op without a trace; single-shot per trace."""
    if trace is None or tracer is None:
        return
    try:
        from ray_tpu_torch.serve import request_trace as RT
        trace.span(RT.FAILED, time.time(), None,
                   error=type(err).__name__, detail=str(err)[:200])
        tracer.finish(trace)
    except Exception:
        pass


class DeploymentResponse:
    """Future-like result of ``handle.remote()`` (reference
    ``handle.py:DeploymentResponse``). Submission to a dead replica
    only surfaces at get-time in this runtime, so the dead-replica
    retry lives HERE: on actor death, the originating handle refreshes
    membership and re-routes once."""

    def __init__(self, ref, retry=None, tracer=None, trace=None):
        self._ref = ref
        self._retry = retry  # () -> DeploymentResponse, single-shot
        self._tracer = tracer
        self._trace = trace

    def result(self, timeout_s: Optional[float] = None):
        try:
            out = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            self._trace = None   # replica-side trace owns the outcome
            return out
        except Exception as e:
            if self._retry is not None and _is_actor_death(e):
                retry, self._retry = self._retry, None
                self._trace = None   # the retry mints a fresh trace
                return retry().result(timeout_s=timeout_s)
            trace, self._trace = self._trace, None
            _ship_failure(self._tracer, trace, e)
            raise

    def _to_object_ref(self):
        return self._ref


def _is_actor_death(e: BaseException) -> bool:
    from ray_tpu_torch.exceptions import ActorDiedError, ActorError
    return isinstance(e, (ActorDiedError, ActorError))


class DeploymentResponseGenerator:
    """Streaming response of ``options(stream=True)`` (reference:
    ``handle.py:DeploymentResponseGenerator``): a thin value-yielding
    view over a core :class:`~ray_tpu_torch.ObjectRefGenerator` — the replica
    executes the method as a streaming generator task, each item is its
    own object reported as produced, and the core credit window paces
    the producer. Iterating yields materialized values; ``cancel()``
    (or GC of an abandoned generator) cancels the replica-side task and
    frees unconsumed items. A replica death before the first item
    re-routes once, like unary ``DeploymentResponse``."""

    def __init__(self, gen, router=None, rkey=None, retry=None,
                 tracer=None, trace=None):
        self._gen = gen          # core ObjectRefGenerator
        self._router = router
        self._rkey = rkey
        self._retry = retry      # () -> DeploymentResponseGenerator
        self._tracer = tracer
        self._trace = trace
        self._started = False
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            ref = next(self._gen)
        except StopIteration:
            self._trace = None   # clean end: the replica shipped it
            self._finish()
            raise
        except Exception as e:
            if not self._started and self._retry is not None \
                    and _is_actor_death(e):
                # membership was stale and the replica is gone: resync
                # and re-route this stream once
                retry, self._retry = self._retry, None
                self._finish()
                fresh = retry()
                self._gen = fresh._gen
                self._router = fresh._router
                self._rkey = fresh._rkey
                self._tracer = fresh._tracer
                self._trace = fresh._trace
                self._done = False
                return next(self)
            trace, self._trace = self._trace, None
            _ship_failure(self._tracer, trace, e)
            self._finish()
            raise
        self._started = True
        try:
            return ray_tpu_torch.get(ref)
        except BaseException as e:
            # a mid-stream exception is delivered as the failing item:
            # the stream is over — release the router's stream count.
            # A dead replica cannot ship its trace, so the router part
            # records the FAILED terminal here.
            trace, self._trace = self._trace, None
            _ship_failure(self._tracer, trace, e)
            self._finish()
            raise

    def _finish(self) -> None:
        if not self._done:
            self._done = True
            if self._router is not None:
                self._router.stream_finished(self._rkey)

    def cancel(self) -> None:
        if not self._done:
            self._finish()
            self._gen.close()

    def __del__(self):
        try:
            self.cancel()
        except Exception:
            pass


class _Router:
    """Shared routing state: membership, per-replica load, model
    affinity. One _Router is shared by a handle and every configured
    copy made via ``options()``, so load tracking spans them all."""

    #: seconds a gauge snapshot stays fresh before a new async probe
    gauge_refresh_s = 0.5
    #: direct-probe silence after which the fleet plane backfills
    gauge_stale_s = 3.0
    #: gauge-score bonus for a replica whose radix trie already holds a
    #: first-turn request's prefix (worth ~a free-slot fraction — a
    #: warm prefix beats marginal capacity, but never a dead replica)
    prefix_match_bonus = 1.5
    #: seconds between admission-policy refreshes from the controller
    admission_policy_poll_s = 2.0

    def __init__(self, deployment_name: str, controller):
        self.deployment_name = deployment_name
        self.controller = controller
        self.version = -1
        self.replicas: List[Any] = []
        # stable replica key (actor id hex) -> outstanding unary refs
        self.outstanding: Dict[bytes, List[Any]] = {}
        # stable replica key -> live stream count
        self.streams: Dict[bytes, int] = {}
        # model id -> stable replica key (soft affinity, reference:
        # multiplexed model routing in replica_scheduler)
        self.model_affinity: Dict[str, bytes] = {}
        # session id -> stable replica key: multi-turn stickiness so a
        # session's shared prefix blocks stay where its KV lives
        self.session_affinity: Dict[str, bytes] = {}
        self.policy = "gauge"
        # -- gauge cache: rkey -> {"t": monotonic, <engine stats>}
        self.gauges: Dict[bytes, Dict[str, Any]] = {}
        self._gauge_refs: Dict[bytes, Any] = {}   # in-flight probes
        self._pids: Dict[int, bytes] = {}         # replica pid -> rkey
        self._last_probe = 0.0
        self._rr_next = 0
        # SLO-aware admission (serve/admission.py); shared across
        # options() copies like the rest of the router so per-tenant
        # budget accounting spans them. None = admit everything.
        self.admission = None
        self._last_policy_poll = 0.0
        # per-request tracer (serve/request_trace.py): mints
        # request_ids + the 1-in-N sampling verdict at the routing
        # tier; shared across options() copies so the sample cadence
        # spans them. Built lazily (needs the runtime config).
        self.tracer = None

    def _get_tracer(self):
        if self.tracer is None:
            from ray_tpu_torch.serve.request_trace import RequestTracer
            cfg = None
            try:
                from ray_tpu_torch.core.global_state import try_global_worker
                cfg = getattr(try_global_worker(), "config", None)
            except Exception:
                pass
            self.tracer = RequestTracer(cfg, part="router")
        return self.tracer

    @staticmethod
    def _key(replica) -> bytes:
        aid = getattr(replica, "_actor_id", None)
        return aid.binary() if aid is not None else id(replica)

    def refresh(self, force: bool = False) -> None:
        version = ray_tpu_torch.get(
            self.controller.get_version.remote(self.deployment_name))
        if version != self.version or force:
            # Atomic snapshot: version and replica list must agree.
            version, replicas = ray_tpu_torch.get(
                self.controller.get_membership.remote(self.deployment_name))
            self.replicas = replicas
            self.version = version
            live = {self._key(r) for r in replicas}
            # stable keys survive a membership change for replicas that
            # remain; state for removed replicas is dropped, and affinity
            # to a vanished replica is invalidated rather than silently
            # pointing at a different one
            self.outstanding = {k: v for k, v in self.outstanding.items()
                                if k in live}
            self.streams = {k: v for k, v in self.streams.items()
                            if k in live}
            self.model_affinity = {m: k for m, k in
                                   self.model_affinity.items() if k in live}
            self.session_affinity = {
                s: k for s, k in self.session_affinity.items()
                if k in live}
            self.gauges = {k: v for k, v in self.gauges.items()
                           if k in live}
            self._gauge_refs = {k: v for k, v in self._gauge_refs.items()
                                if k in live}
            self._pids = {p: k for p, k in self._pids.items()
                          if k in live}

    def load(self, replica) -> int:
        k = self._key(replica)
        refs = self.outstanding.setdefault(k, [])
        if refs:
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=0)
            self.outstanding[k] = list(pending)
        return len(self.outstanding[k]) + self.streams.get(k, 0)

    # -- gauge probing ------------------------------------------------
    def _poll_gauges(self) -> None:
        """Harvest completed async ``Replica.stats`` probes (never
        blocks the request path) and launch a fresh round when the
        cache ages past ``gauge_refresh_s``."""
        now = time.monotonic()
        for k, ref in list(self._gauge_refs.items()):
            try:
                ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            except Exception:
                del self._gauge_refs[k]
                continue
            if not ready:
                continue
            del self._gauge_refs[k]
            try:
                s = ray_tpu_torch.get(ref)
            except Exception:
                self.gauges.pop(k, None)
                continue
            if isinstance(s, dict):
                g = dict(s.get("engine") or {})
                g["ongoing"] = s.get("ongoing")
                g["t"] = now
                self.gauges[k] = g
                pid = s.get("pid")
                if pid is not None:
                    self._pids[int(pid)] = k
        if now - self._last_probe >= self.gauge_refresh_s:
            self._last_probe = now
            for r in self.replicas:
                k = self._key(r)
                if k not in self._gauge_refs:
                    try:
                        self._gauge_refs[k] = r.stats.remote()
                    except Exception:
                        pass

    def _poll_admission_policy(self) -> None:
        """Refresh the admission controller's shed rules from the
        serve controller's config plane (fed by the dashboard's
        ``POST /api/v0/admission/policy``). Rate-limited; a newer seq
        swaps the policy in place, keeping budget spend windows."""
        if self.admission is None:
            return
        now = time.monotonic()
        if now - self._last_policy_poll < self.admission_policy_poll_s:
            return
        self._last_policy_poll = now
        try:
            seq, d = ray_tpu_torch.get(
                self.controller.get_admission_policy.remote())
        except Exception:
            return
        if d is None or seq <= self.admission.policy_seq:
            return
        from ray_tpu_torch.serve.admission import AdmissionPolicy
        try:
            self.admission.set_policy(AdmissionPolicy.from_dict(d),
                                      seq=seq)
        except ValueError:
            pass  # controller validated on write; never fail a route

    def _fleet_backfill(self) -> None:
        """Direct probes gone quiet (replica event loops saturated):
        fall back to the controller's metrics plane —
        ``/api/v0/metrics/fleet`` aggregates every replica's engine
        gauges — and map rows onto replicas by pid."""
        if not self._pids:
            return
        try:
            from ray_tpu_torch.util.state import fleet_metrics
            rows = fleet_metrics(window_s=10.0).get("rows") or []
        except Exception:
            return
        now = time.monotonic()
        for row in rows:
            k = self._pids.get(row.get("pid"))
            if k is None:
                continue
            # a fleet row is only as fresh as its origin's last metric
            # report: stamping it "now" would let a long-dead replica's
            # numbers route traffic forever. Rows older than the
            # staleness bound are skipped (pow2 fallback); adopted rows
            # carry their ring timestamp so they age out naturally.
            age = float(row.get("last_report_s") or 0.0)
            if age > self.gauge_stale_s:
                continue
            g = self.gauges.setdefault(k, {})
            if now - g.get("t", 0.0) <= self.gauge_stale_s:
                continue   # direct probe is fresher
            if row.get("queue_depth") is not None:
                g["queue_depth"] = row["queue_depth"]
            if row.get("ttft_p50_ms") is not None:
                g["ttft_ewma_s"] = row["ttft_p50_ms"] / 1e3
            g["t"] = now - age

    @staticmethod
    def _has_signal(g: Dict[str, Any]) -> bool:
        return any(key in g for key in
                   ("free_slots", "queue_depth", "ttft_ewma_s"))

    def _fresh_gauges(self) -> Dict[bytes, Dict[str, Any]]:
        now = time.monotonic()
        fresh = {k: g for k, g in self.gauges.items()
                 if now - g.get("t", 0.0) <= self.gauge_stale_s
                 and self._has_signal(g)}
        if not fresh:
            self._fleet_backfill()
            fresh = {k: g for k, g in self.gauges.items()
                     if now - g.get("t", 0.0) <= self.gauge_stale_s
                     and self._has_signal(g)}
        return fresh

    def pick(self, model_id: Optional[str],
             session_id: Optional[str] = None,
             policy: Optional[str] = None,
             prefix_fp: Optional[int] = None):
        """Returns (replica, stable_key). ``prefix_fp`` (a
        ``prefix_cache.prefix_fingerprint`` of the request's leading KV
        block — typically its system prompt) steers a FIRST-turn
        request toward the replica whose radix trie already caches that
        prefix; once a session is pinned, affinity wins and the
        fingerprint is moot."""
        n = len(self.replicas)
        by_key = {self._key(r): r for r in self.replicas}
        policy = policy or self.policy
        if session_id is not None:
            k = self.session_affinity.get(session_id)
            if k is not None and k in by_key:
                # sticky: this session's earlier turns' prefix blocks
                # live (warm) in this replica's radix cache
                return by_key[k], k
        if model_id is not None:
            k = self.model_affinity.get(model_id)
            if k is not None and k in by_key:
                # soft affinity: keep one model's requests on one replica
                # so its weights stay resident
                return by_key[k], k
        replica = None
        if n == 1:
            replica = self.replicas[0]
        elif policy == "round_robin":
            replica = self.replicas[self._rr_next % n]
            self._rr_next += 1
        elif policy == "gauge":
            self._poll_gauges()
            fresh = self._fresh_gauges()

            def score(g):
                s = gauge_score(g)
                if prefix_fp is not None and prefix_fp in \
                        (g.get("prefix_fingerprints") or ()):
                    # cold-session placement: the replica's trie
                    # already holds this request's prefix blocks —
                    # prefill there skips them instead of recomputing
                    s += self.prefix_match_bonus
                return s

            scored = [(score(fresh[self._key(r)]), i, r)
                      for i, r in enumerate(self.replicas)
                      if self._key(r) in fresh]
            if scored:
                # in-flight work this router already routed but the
                # gauges haven't seen yet still counts against a
                # replica (prevents herding between probe rounds)
                best = max(scored, key=lambda t: (
                    t[0] - 0.25 * self.load(t[2]), -t[1]))
                replica = best[2]
        if replica is None:
            # pow2 (or gauge fallback: no engine gauges yet/at all)
            i, j = random.sample(range(n), 2)
            a, b = self.replicas[i], self.replicas[j]
            replica = a if self.load(a) <= self.load(b) else b
        k = self._key(replica)
        if model_id is not None:
            self.model_affinity[model_id] = k
        if session_id is not None:
            self.session_affinity[session_id] = k
        return replica, k

    def stream_started(self, k: bytes) -> None:
        self.streams[k] = self.streams.get(k, 0) + 1

    def stream_finished(self, k: bytes) -> None:
        n = self.streams.get(k, 0) - 1
        if n > 0:
            self.streams[k] = n
        else:
            self.streams.pop(k, None)


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle._route(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 app_name: str = "default", _router: Optional[_Router] = None,
                 _stream: bool = False, _model_id: Optional[str] = None,
                 _session_id: Optional[str] = None,
                 _routing_policy: Optional[str] = None,
                 _prefix_fingerprint: Optional[int] = None,
                 _tenant: Optional[str] = None,
                 _priority=None,
                 _request_id: Optional[str] = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._controller = controller
        self._router = _router or _Router(deployment_name, controller)
        self._stream = _stream
        self._model_id = _model_id
        self._session_id = _session_id
        self._routing_policy = _routing_policy
        self._prefix_fingerprint = _prefix_fingerprint
        self._tenant = _tenant
        self._priority = _priority
        self._request_id = _request_id

    # -- admission ----------------------------------------------------
    def enable_admission(self, policy=None):
        """Attach SLO-aware admission (``serve/admission.py``) to this
        handle's shared router: subsequent calls through this handle or
        any ``options()`` copy pass through per-tenant token budgets
        and priority shedding, raising
        :class:`~ray_tpu_torch.exceptions.AdmissionRejectedError` when shed.
        Returns the :class:`~ray_tpu_torch.serve.admission.
        AdmissionController` (for ``stats()``)."""
        from ray_tpu_torch.serve.admission import AdmissionController
        if not isinstance(policy, AdmissionController):
            policy = AdmissionController(policy)
        self._router.admission = policy
        return policy

    # -- routing ------------------------------------------------------
    def _route(self, method: str, args, kwargs):
        r = self._router
        r.refresh()
        if not r.replicas:
            raise RuntimeError(
                f"Deployment {self.deployment_name!r} has no replicas")
        # Mint the request's trace identity HERE — the routing tier is
        # the first hop that sees every request (proxy-supplied ids
        # arrive via options(request_id=...)). The router is also the
        # sampling authority: the 1-in-N verdict rides the call context
        # to the replica, which materialises the waterfall and ships.
        tracer = r._get_tracer()
        trace = tracer.begin(request_id=self._request_id)
        rid = trace.request_id if trace is not None else self._request_id
        t_enqueue = time.time()
        if r.admission is not None:
            # Shed BEFORE pick: a rejected request must never touch a
            # replica queue (that queue depth is exactly what the shed
            # is protecting). Freshest engine gauges decide overload.
            r._poll_admission_policy()
            r._poll_gauges()
            try:
                r.admission.admit(
                    self._tenant, self._priority, r._fresh_gauges(),
                    tokens=kwargs.get("max_tokens"), request_id=rid)
            except Exception as e:
                # terminal at the router: the replica never sees this
                # request, so the router part ships the (QUEUED, SHED)
                # waterfall — a shed request is traceable from its id
                if trace is not None:
                    from ray_tpu_torch.serve import request_trace as RT
                    now = time.time()
                    trace.span(RT.QUEUED, t_enqueue, now)
                    trace.span(RT.SHED, now, None,
                               error=type(e).__name__,
                               reason=getattr(e, "reason", None),
                               tenant=self._tenant,
                               priority=str(self._priority)
                               if self._priority is not None else None)
                    tracer.finish(trace)
                raise
        # Unwrap chained responses so downstream gets values, not
        # wrapper objects (reference: DeploymentResponse passing).
        args = tuple(a._to_object_ref() if isinstance(a, DeploymentResponse)
                     else a for a in args)
        kwargs = {k: (v._to_object_ref()
                      if isinstance(v, DeploymentResponse) else v)
                  for k, v in kwargs.items()}
        replica, rkey = r.pick(self._model_id, self._session_id,
                               self._routing_policy,
                               prefix_fp=self._prefix_fingerprint)
        ctx = {"multiplexed_model_id": self._model_id or ""}
        if trace is not None:
            g = r.gauges.get(rkey)
            ctx["request_id"] = rid
            ctx["trace"] = {
                "sampled": trace.sampled,
                "enqueue_ts": t_enqueue,
                "policy": self._routing_policy or r.policy,
                "score": round(gauge_score(g), 4) if g else None,
                "admission": "admitted" if r.admission is not None
                else "bypass",
            }
        if self._stream:
            # core streaming generator task: the replica method's items
            # arrive as first-class objects with backpressure and the
            # runtime's delivery/fault guarantees — no replica-held
            # generator state, no chunk polling
            gen = replica.handle_request_stream.options(
                num_returns="streaming").remote(
                    ctx, method, *args, **kwargs)
            r.stream_started(rkey)

            def retry_on_dead_replica():
                r.refresh(force=True)
                return self._route(method, args, kwargs)

            return DeploymentResponseGenerator(
                gen, r, rkey, retry=retry_on_dead_replica,
                tracer=tracer, trace=trace)
        if trace is not None or self._model_id is not None:
            ref = replica.handle_request_ctx.remote(
                ctx, method, *args, **kwargs)
        else:
            ref = replica.handle_request.remote(method, *args, **kwargs)
        r.outstanding.setdefault(rkey, []).append(ref)

        def retry_on_dead_replica():
            # Membership was stale: resync and re-route once.
            r.refresh(force=True)
            return self._route(method, args, kwargs)

        return DeploymentResponse(ref, retry=retry_on_dead_replica,
                                  tracer=tracer, trace=trace)

    def remote(self, *args, **kwargs):
        return self._route("__call__", args, kwargs)

    def __getattr__(self, name: str) -> _MethodCaller:
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def options(self, *, stream: bool = False,
                multiplexed_model_id: Optional[str] = None,
                session_id: Optional[str] = None,
                routing_policy: Optional[str] = None,
                prefix_fingerprint: Optional[int] = None,
                tenant: Optional[str] = None,
                priority=None,
                request_id: Optional[str] = None,
                **kwargs) -> "DeploymentHandle":
        """Configured copy of this handle (reference: handle.options).
        ``session_id`` pins every call to one replica while it lives
        (multi-turn prefix-cache affinity); ``routing_policy`` selects
        "gauge" (default) / "pow2" / "round_robin";
        ``prefix_fingerprint`` (``serve.prefix_fingerprint(tokens,
        kv_block_size)``) steers a first-turn request to the replica
        whose radix cache already holds that prefix; ``tenant`` /
        ``priority`` ("low"/"normal"/"high" or int) tag calls for
        SLO-aware admission when :meth:`enable_admission` is on;
        ``request_id`` pins the next call's trace identity (the HTTP
        proxy forwards the client's ``x-request-id`` through here — an
        unset id is minted fresh per call).
        Unknown options raise rather than silently no-op."""
        if kwargs:
            raise TypeError(
                f"unsupported handle options: {sorted(kwargs)}")
        if routing_policy not in (None, "gauge", "pow2", "round_robin"):
            raise ValueError(
                f"unknown routing_policy {routing_policy!r}")
        if priority is not None:
            from ray_tpu_torch.serve.admission import priority_value
            priority_value(priority)   # raises ValueError on unknown
        return DeploymentHandle(
            self.deployment_name, self._controller, self.app_name,
            _router=self._router, _stream=stream,
            _model_id=multiplexed_model_id, _session_id=session_id,
            _routing_policy=routing_policy,
            _prefix_fingerprint=prefix_fingerprint,
            _tenant=tenant, _priority=priority,
            _request_id=request_id)

    def __reduce__(self):
        # options survive pickling; router state is rebuilt on the far
        # side (membership is fetched fresh there anyway)
        return (_rebuild_handle,
                (self.deployment_name, self._controller, self.app_name,
                 self._stream, self._model_id, self._session_id,
                 self._routing_policy, self._prefix_fingerprint,
                 self._tenant, self._priority, self._request_id))


def _rebuild_handle(deployment_name, controller, app_name, stream,
                    model_id, session_id=None, routing_policy=None,
                    prefix_fingerprint=None, tenant=None,
                    priority=None, request_id=None):
    return DeploymentHandle(deployment_name, controller, app_name,
                            _stream=stream, _model_id=model_id,
                            _session_id=session_id,
                            _routing_policy=routing_policy,
                            _prefix_fingerprint=prefix_fingerprint,
                            _tenant=tenant, _priority=priority,
                            _request_id=request_id)
