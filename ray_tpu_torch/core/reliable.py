"""Reliable-delivery sublayer for the control plane.

The reference runtime gets at-least-once control RPCs for free from gRPC
retries plus the raylet's lease/reconnect machinery; our ZeroMQ transport
has ordered per-peer delivery but NO retransmit — a dropped one-way
message (lossy link, injected fault, severed peer) used to be gone for
good, which is why chaos drops were restricted to message types with
bespoke recovery paths.

This module closes that gap for the critical one-way types
(:data:`RELIABLE_TYPES`): every such message is stamped with a per-process
wire sequence number, the receiver acks (batched ack *ranges* over a new
``MSG_ACK`` message, flushed within a few ms so they effectively
piggyback on existing traffic bursts), and the sender keeps an
unacked-ring that retransmits with jittered exponential backoff
(``ray_tpu_torch/util/backoff.py``) until one of:

- an **ack** arrives (entry dropped from the ring),
- a **peer-death notice** (``drop_target`` — the higher layer already has
  a recovery story for dead peers: lease revocation, actor restart,
  worker-exit task failover),
- the **attempt cap**, which surfaces a typed
  :class:`~ray_tpu_torch.exceptions.DeliveryFailedError` through the ``on_fail``
  hook (and the ``failures`` list) instead of losing the message silently.

Retransmits are made idempotent on the receive side by the same bounded
LRU dedup filter chaos duplication uses (:class:`chaos.SeqDeduper`): a
receiver that already handled ``(sender tag, seq)`` re-acks and drops the
replay, so delivery is at-least-once on the wire and exactly-once-effect
at the handler.

Ordering note: first transmissions keep zmq's per-peer FIFO; a
retransmit can arrive after younger traffic. Every handler of a reliable
type already tolerates reordering (the chaos delay fault injects exactly
this), and the one FIFO-sensitive path — compact actor-call templates —
self-heals via ``TMPL_MISS``.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.util.backoff import backoff_delay

logger = logging.getLogger(__name__)

#: message types carried reliably: the one-way control messages whose
#: loss previously wedged the runtime (dispatch/assign/done/create) plus
#: the object-plane notifications whose loss cost expensive fallback
#: probes (PUT_OBJECT directory announcements, direct TASK_RESULT
#: pushes). Request/reply RPCs are NOT here — their loss already
#: surfaces as a typed RpcTimeoutError at the caller — except
#: CREATE_ACTOR, whose reply is cheap but whose request loss used to eat
#: the full RPC timeout.
RELIABLE_TYPES = frozenset({
    b"DSP",   # TASK_DISPATCH  controller/driver -> worker
    b"ACL",   # ACTOR_CALL     caller -> actor worker (direct)
    b"ASG",   # TASK_ASSIGN    controller -> node
    b"DON",   # TASK_DONE      worker -> controller
    b"CAC",   # CREATE_ACTOR   driver -> controller
    b"KVO",   # KV_OP          any -> controller: a request written into
              # the controller link while it reconnects (a restarted
              # controller) is lost, and its caller would wait the whole
              # RPC timeout; a retransmit reaches the new controller (a
              # port-only addition; each op is idempotent)
    b"PUT",   # PUT_OBJECT     owner/node -> controller
    b"RES",   # TASK_RESULT    worker -> owner / controller -> owner
    b"SIT",   # STREAM_ITEM    worker -> owner (direct): a lost item
              # report would leave a permanent gap in the stream
    b"SEF",   # STREAM_EOF     worker -> owner (direct): loss would hang
              # the consumer's final next() forever
    b"SCR",   # STREAM_CREDIT  owner -> worker (direct): credits are
              # cumulative so a lost one is healed by the next — but the
              # LAST credit has no successor, and its loss would wedge
              # the producer at the backpressure window for good
    b"TEV",   # TASK_EVENTS    any -> controller: flight-recorder flush
              # (core/events.py). Dedup at the controller makes the
              # merged event stream exactly-once-effect like the
              # lifecycle messages it describes; the producer side
              # stays fire-and-forget (a flush never blocks a task)
    b"MRT",   # METRIC_REPORT  any -> controller: fleet metric snapshot
              # (core/metrics_plane.py). Same contract as TEV —
              # exactly-once-effect at the controller, fire-and-forget
              # for the producer; the reporter additionally abandons
              # superseded in-flight reports via drop_oldest_of (a
              # snapshot is cumulative, so only the newest matters)
    b"RSP",   # REQUEST_SPANS  any -> controller: per-request trace
              # span batch (serve/request_trace.py). Same contract as
              # TEV — exactly-once-effect at the controller (the store
              # additionally dedups by (request_id, part, seq) so a
              # chaos dup never doubles a waterfall), fire-and-forget
              # for the producer
})

#: payload key carrying ``(sender tag, seq)``; popped before handlers
STAMP = "__rseq__"


def _compress(seqs: List[int]) -> List[Tuple[int, int]]:
    """Sorted-unique seq list -> inclusive ``(lo, hi)`` ranges."""
    out: List[List[int]] = []
    for s in sorted(set(seqs)):
        if out and s == out[-1][1] + 1:
            out[-1][1] = s
        else:
            out.append([s, s])
    return [(a, b) for a, b in out]


class ReliableTransport:
    """Per-process ack/retransmit engine. One instance serves every link
    the process speaks on (controller DEALER + direct peer channels) —
    the ``resend``/``send_ack`` callbacks route by target.

    ``resend(target, mtype, payload)`` re-enqueues a message through the
    process's normal (thread-safe) send path; the payload is already
    stamped, so the transport-side ``stamp()`` hook must treat it as a
    pass-through. ``send_ack(route, payload)`` ships a ``MSG_ACK`` back
    over the link a stamped message arrived on (``route`` is whatever
    opaque key the receiver passed to :meth:`on_receive`).
    """

    def __init__(self, resend: Callable[[Any, bytes, dict], None],
                 send_ack: Callable[[Any, dict], None], *,
                 base_s: float = 0.25, cap_s: float = 5.0,
                 max_attempts: int = 12, ack_delay_s: float = 0.02,
                 types: frozenset = RELIABLE_TYPES,
                 rng=None, on_fail: Optional[Callable] = None,
                 name: str = "", start_thread: bool = True,
                 recorder=None):
        from ray_tpu_torch.core.chaos import SeqDeduper
        self._resend = resend
        self._send_ack = send_ack
        self._base = base_s
        self._cap = cap_s
        self._max_attempts = max_attempts
        self._ack_delay = ack_delay_s
        self._types = types
        self._rng = rng
        self._on_fail = on_fail
        self.name = name
        #: flight recorder (core/events.py FlightRecorder) for
        #: RETRANSMIT / DUP_DROPPED / ACK_RTT / DELIVERY_FAILED events;
        #: None keeps every hook a single attribute check
        self.recorder = recorder
        self._metrics = None  # lazily-bound runtime metric handles

        #: unique per process *instance*: distinguishes sender streams at
        #: a receiver and fences stale acks across restarts
        self.tag = os.urandom(8)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        #: seq -> {target, mtype, payload, attempts, due, born}
        self._ring: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        #: route -> sender tag -> [seqs to ack]
        self._pending_acks: Dict[Any, Dict[bytes, List[int]]] = {}
        self._ack_first_at: Optional[float] = None
        self._dedup = SeqDeduper(cap=65536)
        self._stopped = threading.Event()
        self.stats: "collections.Counter" = collections.Counter()
        #: bounded log of messages given up on (typed errors)
        self.failures: List[BaseException] = []
        self._thread: Optional[threading.Thread] = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._loop, name=f"{name or 'reliable'}-retx",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ sender
    def stamp(self, target: Any, mtype: bytes, payload: Any) -> Any:
        """Send-path hook: stamp a reliable message and record it in the
        unacked ring. Pass-through for non-reliable types, non-dict
        payloads, and already-stamped retransmits (their ring entry — and
        seq — must survive the resend)."""
        if mtype not in self._types or not isinstance(payload, dict) \
                or STAMP in payload:
            return payload
        now = time.monotonic()
        with self._cond:
            seq = next(self._seq)
            payload = dict(payload, **{STAMP: (self.tag, seq)})
            self._ring[seq] = {
                "target": target, "mtype": mtype, "payload": payload,
                "attempts": 0, "due": now + self._delay(0), "born": now}
            self.stats["sent"] += 1
            # per-type sent accounting: lets tests and postmortems
            # assert which paths rode reliable delivery (e.g. the disagg
            # KV hand-off's ACL calls) without scraping the ring
            self.stats["sent:" + mtype.decode("ascii", "replace")] += 1
            self._cond.notify()
        return payload

    def _m(self):
        """Lazily-bound runtime metric handles (import deferred: unit
        tests drive bare transports with no runtime around)."""
        m = self._metrics
        if m is None:
            from ray_tpu_torch.core.metric_defs import runtime_metrics
            base = runtime_metrics()
            m = self._metrics = (
                base.retransmits,            # 0: Counter by type
                base.ack_rtt.bound(),        # 1: Histogram
                base.dup_dropped.bound(),    # 2: Counter
                base.delivery_failed.bound(),  # 3: Counter
                base.ack_batch_size.bound())   # 4: Histogram
        return m

    @staticmethod
    def _task_hex(payload) -> Optional[str]:
        tid = payload.get("task_id") if isinstance(payload, dict) else None
        return tid.hex() if isinstance(tid, bytes) else tid

    def _note_retransmit(self, mtype: bytes, payload: dict,
                         attempt: int) -> None:
        try:
            kind = mtype.decode("ascii", "replace")
            self._m()[0].inc(tags={"type": kind})
            if self.recorder is not None:
                self.recorder.record("RETRANSMIT", type=kind,
                                     attempt=attempt,
                                     task=self._task_hex(payload))
        except Exception:
            pass

    def _delay(self, attempt: int) -> float:
        # "equal" jitter keeps a floor of half the window: a retransmit
        # fired before the receiver's batched ack can possibly return is
        # a guaranteed duplicate
        return backoff_delay(attempt, self._base, self._cap,
                             jitter="equal", rng=self._rng)

    def on_ack(self, m: dict) -> None:
        """Handle an incoming ``MSG_ACK``: drop acked seqs from the ring.
        Acks stamped with another instance's tag (pre-restart traffic)
        are ignored."""
        now = time.monotonic()
        acked = []
        with self._cond:
            for tag, ranges in m.get("acks", ()):
                if tag != self.tag:
                    continue
                for lo, hi in ranges:
                    for seq in range(lo, hi + 1):
                        e = self._ring.pop(seq, None)
                        if e is not None:
                            self.stats["acked"] += 1
                            acked.append(e)
        for e in acked:
            # send-to-ack latency (retransmit attempts included): the
            # per-message delivery-health signal
            try:
                rtt = now - e["born"]
                self._m()[1].observe(rtt)
                if e["attempts"] > 0 and self.recorder is not None:
                    # only retransmitted messages are interesting enough
                    # to keep as events — a healthy ack would flood the
                    # ring with one event per message
                    self.recorder.record(
                        "ACK_RTT", rtt_s=round(rtt, 6),
                        attempts=e["attempts"],
                        type=e["mtype"].decode("ascii", "replace"),
                        task=self._task_hex(e["payload"]))
            except Exception:
                pass

    def drop_target(self, target: Any) -> int:
        """Peer-death notice: stop retransmitting to ``target`` (the
        higher layer owns recovery for dead peers). Returns the number of
        abandoned messages."""
        with self._cond:
            gone = [s for s, e in self._ring.items()
                    if e["target"] == target]
            for s in gone:
                del self._ring[s]
            self.stats["dropped_dead_peer"] += len(gone)
        return len(gone)

    @property
    def unacked(self) -> int:
        with self._lock:
            return len(self._ring)

    def drop_oldest_of(self, mtype: bytes, keep: int) -> int:
        """Abandon the OLDEST unacked in-flight messages of ``mtype``
        beyond ``keep`` newest. For supersedable periodic reports
        (METRIC_REPORT): a newer cumulative snapshot makes older ones
        worthless, so retransmitting them through an outage is pure
        backlog — the caller counts what it asked to drop. Returns the
        number abandoned."""
        with self._cond:
            seqs = [s for s, e in self._ring.items()
                    if e["mtype"] == mtype]
            n = len(seqs) - max(0, keep)
            if n <= 0:
                return 0
            for s in seqs[:n]:  # ring is seq-ordered: oldest first
                del self._ring[s]
            self.stats["dropped_superseded"] += n
            return n

    # ---------------------------------------------------------- receiver
    def on_receive(self, route: Any, payload: Any) -> bool:
        """Receive-path hook: pop the wire stamp, queue a batched ack
        back over ``route``, and return True when the payload is a
        retransmit duplicate that must be discarded (the ack is still
        queued — the original's ack may have been the loss)."""
        if not isinstance(payload, dict):
            return False
        key = payload.pop(STAMP, None)
        if key is None:
            return False
        tag, seq = key
        with self._cond:
            self._pending_acks.setdefault(route, {}) \
                .setdefault(tag, []).append(seq)
            if self._ack_first_at is None:
                self._ack_first_at = time.monotonic()
            self._cond.notify()
        if self._dedup.seen(key):
            self.stats["dup_dropped"] += 1
            try:
                self._m()[2].inc()
                if self.recorder is not None:
                    self.recorder.record(
                        "DUP_DROPPED", task=self._task_hex(payload))
            except Exception:
                pass
            return True
        return False

    # -------------------------------------------------------- the engine
    def flush_acks(self) -> None:
        """Ship every pending ack now (callable from any thread; the
        background loop also calls this on its timer)."""
        with self._cond:
            batches = self._take_acks_locked()
        self._ship_acks(batches)

    def _take_acks_locked(self) -> List[Tuple[Any, dict]]:
        if not self._pending_acks:
            return []
        pending, self._pending_acks = self._pending_acks, {}
        self._ack_first_at = None
        out = []
        for route, per_tag in pending.items():
            acks = [(tag, _compress(seqs))
                    for tag, seqs in per_tag.items()]
            out.append((route, {"acks": acks}))
        return out

    def _ship_acks(self, batches: List[Tuple[Any, dict]]) -> None:
        for route, payload in batches:
            try:
                self._send_ack(route, payload)
                self.stats["acks_sent"] += 1
            except Exception:
                logger.exception("%s: ack send failed", self.name)
                continue
            try:
                self._m()[4].observe(sum(
                    hi - lo + 1 for _, ranges in payload["acks"]
                    for lo, hi in ranges))
            except Exception:
                pass

    def _collect_due_locked(self, now: float):
        resends, failures = [], []
        for seq in list(self._ring):
            e = self._ring[seq]
            if e["due"] > now:
                continue
            e["attempts"] += 1
            if e["attempts"] > self._max_attempts:
                del self._ring[seq]
                from ray_tpu_torch.exceptions import DeliveryFailedError
                failures.append(DeliveryFailedError(
                    e["mtype"], target=e["target"],
                    attempts=e["attempts"] - 1,
                    elapsed_s=now - e["born"]))
                continue
            e["due"] = now + self._delay(e["attempts"])
            resends.append((e["target"], e["mtype"], e["payload"],
                            e["attempts"]))
        return resends, failures

    def _note_failure(self, err) -> None:
        try:
            self._m()[3].inc()
            if self.recorder is not None:
                self.recorder.record("DELIVERY_FAILED", error=str(err))
        except Exception:
            pass

    def _next_wake_locked(self, now: float) -> Optional[float]:
        wake = None
        if self._ring:
            wake = min(e["due"] for e in self._ring.values())
        if self._ack_first_at is not None:
            ack_at = self._ack_first_at + self._ack_delay
            wake = ack_at if wake is None else min(wake, ack_at)
        if wake is None:
            return None
        return max(0.0, wake - now)

    def _loop(self) -> None:
        while not self._stopped.is_set():
            with self._cond:
                self._cond.wait(self._next_wake_locked(time.monotonic()))
                if self._stopped.is_set():
                    return
                now = time.monotonic()
                resends, failures = self._collect_due_locked(now)
                acks = []
                if self._ack_first_at is not None and \
                        now >= self._ack_first_at + self._ack_delay:
                    acks = self._take_acks_locked()
            self._ship_acks(acks)
            for target, mtype, payload, attempt in resends:
                self.stats["retransmit"] += 1
                self._note_retransmit(mtype, payload, attempt)
                try:
                    self._resend(target, mtype, payload)
                except Exception:
                    logger.exception("%s: retransmit of %s failed",
                                     self.name, mtype)
            for err in failures:
                self.stats["delivery_failed"] += 1
                self._note_failure(err)
                if len(self.failures) < 256:
                    self.failures.append(err)
                logger.error("%s: %s", self.name, err)
                if self._on_fail is not None:
                    try:
                        self._on_fail(err)
                    except Exception:
                        logger.exception("%s: on_fail hook failed",
                                         self.name)

    def step(self, now: Optional[float] = None) -> None:
        """Single-threaded driver for tests (``start_thread=False``):
        run one retransmit/ack pass at ``now``."""
        if now is None:
            now = time.monotonic()
        with self._cond:
            resends, failures = self._collect_due_locked(now)
            acks = self._take_acks_locked()
        self._ship_acks(acks)
        for target, mtype, payload, attempt in resends:
            self.stats["retransmit"] += 1
            self._note_retransmit(mtype, payload, attempt)
            self._resend(target, mtype, payload)
        for err in failures:
            self.stats["delivery_failed"] += 1
            self._note_failure(err)
            if len(self.failures) < 256:
                self.failures.append(err)
            if self._on_fail is not None:
                self._on_fail(err)

    def stop(self) -> None:
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def maybe_transport(config, resend, send_ack, *, rng=None,
                    on_fail=None, name: str = "",
                    recorder=None) -> Optional[ReliableTransport]:
    """Build the process's transport from config; None when the layer is
    disabled (``RAY_TPU_TORCH_RELIABLE_DELIVERY=0``) so every hook stays a
    single attribute check."""
    if not getattr(config, "reliable_delivery", True):
        return None
    return ReliableTransport(
        resend, send_ack,
        base_s=getattr(config, "retransmit_base_s", 0.25),
        cap_s=getattr(config, "retransmit_cap_s", 5.0),
        max_attempts=getattr(config, "retransmit_max_attempts", 12),
        ack_delay_s=getattr(config, "ack_flush_delay_s", 0.02),
        rng=rng, on_fail=on_fail, name=name, recorder=recorder)
