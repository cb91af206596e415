"""Deterministic, seed-driven fault injection for the control plane.

The reference gates releases on fault injection — ``testing_rpc_failure``
in ``ray_config_def.h`` lets any RPC be dropped/delayed by config, and the
chaos test utils SIGKILL raylets and workers mid-run. This module is that
subsystem for this runtime: every process's transport choke point
(``Runtime._flush_box``, ``NodeManager._send``/``_send_direct``,
``Controller._send``) consults one seeded PRNG stream before a message
hits the wire, so a failing run replays from its seed.

Three layers:

- **Message faults** (:class:`ChaosInjector`): per-message-type drop /
  delay / duplicate plus peer severing, decided from
  ``random.Random(f"{seed}:{stream}")`` where ``stream`` names the
  process role (``driver``, ``controller``, ``node``, ``worker:<n>`` —
  workers get a stable spawn index via ``RAY_TPU_TORCH_CHAOS_ID``). Each
  message consumes a fixed number of draws, so the decision sequence for
  a given (seed, stream, config) is reproducible.
- **Scheduled partitions** (``ChaosConfig.partitions``): a time-indexed
  sever matrix — ``{"start": s, "end": s, "a": role, "b": role}`` cuts
  BOTH directions of the matching link (controller<->node,
  controller<->peer, node<->node) for the window, measured from each
  process's injector creation, then heals. Unlike probabilistic drops a
  partition cuts *everything* on the link, protected types included —
  real partitions don't read message headers. Recovery comes from the
  reliable-delivery layer (``core/reliable.py``) retransmitting the
  critical set after the heal, plus the periodic/reconnect machinery.
- **Duplicate hardening** (:class:`SeqDeduper`): while injection is
  active every injectable payload is stamped with a per-process wire
  sequence number and receivers drop replays — the duplication fault
  continuously proves the at-least-once dedup path (the reliable layer
  runs its own always-on instance against retransmit duplicates).
- **Disk faults** (:class:`DiskFaultInjector`): seeded ``EIO`` /
  ``ENOSPC`` / truncated-read faults on the spill path
  (``native_store.py`` spill writes and restore reads), proving the
  store degrades gracefully — retry with backoff, fall back to re-pull
  from another holder, and only then surface a typed
  ``ObjectLostError``.
- **Process faults** (:class:`ChaosMonkey`): driver/test-side scheduler
  for SIGKILLing workers and node managers mid-task and for controller
  pause/restart, driven by the same seed.

Activation is environment-driven so it propagates to every spawned
process: ``RAY_TPU_TORCH_CHAOS_SEED=<int>`` turns injection on;
``RAY_TPU_TORCH_CHAOS_CONFIG=<json>`` tunes probabilities (fields of
:class:`ChaosConfig`). Production runs never touch this module's hot
path — the injector handle is ``None`` and every hook is a single
attribute check.

Determinism note: decision *streams* are bit-reproducible per process;
end-to-end message interleaving still depends on OS scheduling. The
contract chaos tests rely on is that a fixed (seed, config, workload)
exercises the same fault mix and the asserted invariants (no hangs,
typed errors, drained refcounts, no leaked processes) hold on every
replay.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_SEED = "RAY_TPU_TORCH_CHAOS_SEED"
ENV_CONFIG = "RAY_TPU_TORCH_CHAOS_CONFIG"
ENV_STREAM_ID = "RAY_TPU_TORCH_CHAOS_ID"

#: message types whose loss the runtime cannot recover from — the
#: registration handshake and RPC replies have no retransmit, and
#: RECONNECT is itself the recovery signal. Never injected.
PROTECTED_TYPES = frozenset({"REG", "REGR", "BYE", "RPL", "ERR", "RCN"})

#: default targets for a scalar ``drop_prob``: message types with
#: drop-recovery machinery. PING/HEARTBEAT are periodic; everything
#: else is covered by the reliable-delivery layer's ack/retransmit
#: (core/reliable.py) — which is what finally let the scalar mix cover
#: the whole critical one-way control plane (TASK_DISPATCH, ACTOR_CALL,
#: TASK_ASSIGN, TASK_DONE) instead of a hand-picked safe subset.
#: Request/reply types (SUB, KVO, ...) still need an explicit per-type
#: entry: their drop surfaces as the caller's RpcTimeoutError, which is
#: a worse failure mode to inject by default. SIT/SEF/SCR are the
#: streaming-generator item/EOF/credit reports — covered by the same
#: ack/retransmit layer, so dropping them must still deliver every
#: yielded item exactly once, in order.
#: TEV is the flight-recorder flush (core/events.py): reliably
#: delivered like its peers, and observability loss must never block
#: task progress — exactly the contract chaos drops exercise.
#: MRT is the fleet metric snapshot (core/metrics_plane.py): same
#: contract as TEV, plus reporter-side supersede (drop-oldest) so a
#: sustained 100% drop window bounds the retransmit backlog.
#: RSP is the per-request trace span batch (serve/request_trace.py):
#: same contract as TEV, plus controller-side dedup by
#: (request_id, part, seq) so a dup never yields a double waterfall.
DEFAULT_DROPPABLE = frozenset({"RES", "PUT", "PNG", "HBT",
                               "DSP", "ACL", "ASG", "DON",
                               "SIT", "SEF", "SCR", "TEV", "MRT",
                               "RSP"})


@dataclass
class ChaosConfig:
    """Fault mix for one chaos run. ``drop``/``dup``/``delay`` map a
    message-type name (``"RES"``, ``"PUT"``, ... or ``"*"``) to a
    probability and override the scalar ``*_prob`` defaults.

    ``partitions`` is the scheduled sever matrix: a list of windows
    (seconds from injector creation) in one of two forms:

    - ``{"start": s, "end": s, "a": side, "b": side}`` — cuts every
      message, BOTH directions, on links whose (sender, target) match
      either orientation;
    - ``{"start": s, "end": s, "src": side, "dst": side}`` — an
      **asymmetric one-way window**: only messages FROM a matching
      sender TO a matching target are cut (the reverse direction flows
      normally — the classic half-open link real networks produce).

    A *side* is a role class (``"controller"``, ``"node"``,
    ``"driver"``, ``"worker"``, ``"peer"``, ``"*"``) or a **concrete
    identity**: ``"id:<hexprefix>"`` matches the process's own wire
    identity (sender side) or the target identity (receiver side) by
    hex prefix — so partitions can be keyed to specific node ids
    (:func:`node_identity` renders a NodeID's wire identity) or worker
    ids, not just role classes. Role classes remain coarse: driver and
    worker targets are indistinguishable at the sender (both are
    opaque 28-byte DEALER identities), so either name matches any
    non-node peer; node identities are recognized by their ``b"N"``
    prefix.

    ``latency`` injects **slow links** (not cut links): a list of
    ``{"start": s, "end": s, "src"/"dst" | "a"/"b": side, "prob": p,
    "dist": "uniform"|"exp"|"lognormal", ...params}`` windows; every
    matching message is held for a delay drawn from the distribution
    (``uniform``: ``lo``/``hi``; ``exp``: ``mean``; ``lognormal``:
    ``mu``/``sigma``, in seconds). Draws come from an independent
    seeded stream, so adding latency shifts no drop/dup decisions.
    This is how streaming backpressure is soaked under skew — a slow
    consumer link, not a dead one.

    ``disk``/``disk_fault_prob`` drive the spill-path disk faults
    (ops: ``"spill_write"`` -> EIO/ENOSPC, ``"restore_read"`` ->
    EIO/truncated read), consumed by :class:`DiskFaultInjector`.

    ``maintenance`` schedules **simulated TPU maintenance events**
    against slice providers (consumed by
    ``autoscaler/node_provider.py::FakeSliceProvider``): a list of
    ``{"after_s": t, "slice_index": i, "kind": "maintenance"}``
    entries — ``t`` seconds after provider creation the i-th slice it
    created (0-based, by creation order) receives a drain notice, which
    the SliceManager turns into the full preemption-aware drain
    (notice → draining → placement groups reschedule → release)."""

    seed: int = 0
    drop_prob: float = 0.0            # over DEFAULT_DROPPABLE
    dup_prob: float = 0.0             # over all unprotected types
    delay_prob: float = 0.0           # over all unprotected types
    delay_range_s: Tuple[float, float] = (0.002, 0.1)
    drop: Dict[str, float] = field(default_factory=dict)
    dup: Dict[str, float] = field(default_factory=dict)
    delay: Dict[str, float] = field(default_factory=dict)
    partitions: List[Dict] = field(default_factory=list)
    latency: List[Dict] = field(default_factory=list)
    disk_fault_prob: float = 0.0      # over all spill-path disk ops
    disk: Dict[str, float] = field(default_factory=dict)
    maintenance: List[Dict] = field(default_factory=list)

    @classmethod
    def from_env(cls) -> Optional["ChaosConfig"]:
        seed_raw = os.environ.get(ENV_SEED)
        cfg_raw = os.environ.get(ENV_CONFIG)
        if not seed_raw and not cfg_raw:
            return None
        cfg = cls()
        if cfg_raw:
            try:
                data = json.loads(cfg_raw)
            except ValueError:
                logger.warning("chaos: unparseable %s; injection disabled",
                               ENV_CONFIG)
                return None
            for k, v in data.items():
                if k == "delay_range_s":
                    cfg.delay_range_s = (float(v[0]), float(v[1]))
                elif hasattr(cfg, k):
                    setattr(cfg, k, v)
        if seed_raw:
            try:
                cfg.seed = int(seed_raw)
            except ValueError:
                logger.warning("chaos: non-integer %s=%r; injection "
                               "disabled", ENV_SEED, seed_raw)
                return None
        return cfg

    def env(self) -> Dict[str, str]:
        """Env vars that reproduce this config in a child process."""
        return {
            ENV_SEED: str(self.seed),
            ENV_CONFIG: json.dumps({
                "drop_prob": self.drop_prob, "dup_prob": self.dup_prob,
                "delay_prob": self.delay_prob,
                "delay_range_s": list(self.delay_range_s),
                "drop": self.drop, "dup": self.dup, "delay": self.delay,
                "partitions": self.partitions,
                "latency": self.latency,
                "disk_fault_prob": self.disk_fault_prob,
                "disk": self.disk,
                "maintenance": self.maintenance,
            }),
        }

    def _prob(self, table: Dict[str, float], scalar: float,
              scalar_set: Optional[frozenset], name: str) -> float:
        if name in PROTECTED_TYPES:
            return 0.0
        if name in table:
            return table[name]
        if "*" in table:
            return table["*"]
        if scalar_set is None or name in scalar_set:
            return scalar
        return 0.0

    def drop_p(self, name: str) -> float:
        return self._prob(self.drop, self.drop_prob, DEFAULT_DROPPABLE, name)

    def dup_p(self, name: str) -> float:
        return self._prob(self.dup, self.dup_prob, None, name)

    def delay_p(self, name: str) -> float:
        return self._prob(self.delay, self.delay_prob, None, name)

    def disk_p(self, op: str) -> float:
        return self.disk.get(op, self.disk.get("*", self.disk_fault_prob))


class SeqDeduper:
    """Receiver-side at-least-once filter: drops payloads whose
    ``(sender tag, wire seq)`` was already seen. Bounded LRU — chaos
    duplicates arrive within a handful of messages of the original, so a
    few thousand entries of history is orders of magnitude more than the
    replay window."""

    def __init__(self, cap: int = 8192):
        self._cap = cap
        self._seen: "collections.OrderedDict[tuple, None]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.dropped = 0

    def seen(self, key) -> bool:
        try:
            hash(key)
        except TypeError:
            return False
        with self._lock:
            if key in self._seen:
                self.dropped += 1
                return True
            self._seen[key] = None
            while len(self._seen) > self._cap:
                self._seen.popitem(last=False)
            return False


class ChaosInjector:
    """Per-process message-fault decider. ``plan_send`` is the single
    entry point the transports call; it returns the (possibly empty)
    list of ``(delay_s, payload)`` copies to actually ship."""

    def __init__(self, config: ChaosConfig, stream: str,
                 self_id: Optional[str] = None):
        self.config = config
        self.stream = stream
        self.role = stream.split(":", 1)[0]
        #: this process's wire identity (hex), for concrete-id partition
        #: and latency-link matching (``"id:<hexprefix>"`` sides)
        self.self_id = self_id or ""
        self._rng = random.Random(f"{config.seed}:{stream}")
        #: independent stream for latency-link draws: enabling slow
        #: links must not shift the drop/dup/delay decision sequence
        self._lat_rng = random.Random(f"{config.seed}:{stream}:latency")
        self._lock = threading.Lock()
        #: scheduled-partition clock origin: windows are seconds from
        #: injector creation (process start for spawned processes)
        self._t0 = time.monotonic()
        #: peers cut off (drop everything both directions this process
        #: sees). ``None`` severs the controller link.
        self._severed: set = set()
        #: receiver dedup key: unique per process *instance* (not per
        #: replay — it only needs to distinguish senders at a receiver)
        self._tag = os.urandom(8)
        self._seq = itertools.count(1)
        self.stats: "collections.Counter" = collections.Counter()

    def rng_for(self, name: str) -> random.Random:
        """Independent deterministic stream for an auxiliary consumer
        (e.g. the lease backoff), so its draws don't perturb the message
        decision sequence."""
        return random.Random(f"{self.config.seed}:{self.stream}:{name}")

    # ------------------------------------------------------------- sever
    def sever(self, peer: Optional[bytes]) -> None:
        with self._lock:
            self._severed.add(peer)

    def heal(self, peer: Optional[bytes] = None) -> None:
        with self._lock:
            if peer is None:
                self._severed.clear()
            else:
                self._severed.discard(peer)

    # -------------------------------------------------- partitions
    def _side_matches_role(self, side: str, role: str) -> bool:
        if side.startswith("id:"):
            # concrete identity: match this process's own wire id
            return bool(self.self_id) and \
                self.self_id.startswith(side[3:].lower())
        return side == "*" or side == role or \
            (side in ("driver", "worker", "peer")
             and role in ("driver", "worker"))

    @staticmethod
    def _target_class(target: Optional[bytes]) -> str:
        if target is None:
            return "controller"
        if len(target) == 28 and target[:1] == b"N":
            return "node"
        return "peer"  # worker or driver: indistinguishable identities

    @staticmethod
    def _side_matches_target(side: str, tclass: str,
                             target: Optional[bytes] = None) -> bool:
        if side.startswith("id:"):
            # concrete identity: match the wire target by hex prefix
            return target is not None and \
                target.hex().startswith(side[3:].lower())
        return side == "*" or side == tclass or \
            (side in ("driver", "worker", "peer") and tclass == "peer")

    def _link_matches(self, p: Dict, target: Optional[bytes],
                      tclass: str) -> bool:
        """One window against one (this process -> target) link.
        ``src``/``dst`` windows are ASYMMETRIC: only the named
        direction is affected (this process must match ``src`` as the
        sender). ``a``/``b`` windows match either orientation."""
        if "src" in p or "dst" in p:
            return self._side_matches_role(p.get("src", "*"), self.role) \
                and self._side_matches_target(p.get("dst", "*"), tclass,
                                              target)
        a, b = p.get("a", "*"), p.get("b", "*")
        return (self._side_matches_role(a, self.role)
                and self._side_matches_target(b, tclass, target)) or \
               (self._side_matches_role(b, self.role)
                and self._side_matches_target(a, tclass, target))

    def _partitioned(self, target: Optional[bytes], now: float) -> bool:
        """True when a scheduled partition window currently severs the
        (this role -> target) link. Pure time check — consumes no RNG
        draws, so adding partitions to a config shifts no other fault
        decisions."""
        t = now - self._t0
        tclass = self._target_class(target)
        for p in self.config.partitions:
            if not (p.get("start", 0.0) <= t < p.get("end", float("inf"))):
                continue
            if self._link_matches(p, target, tclass):
                return True
        return False

    def _link_delay(self, target: Optional[bytes], now: float) -> float:
        """Latency-distribution injection: extra delay for this message
        from matching slow-link windows (``ChaosConfig.latency``).
        Draws come from the dedicated ``:latency`` stream."""
        if not self.config.latency:
            return 0.0
        t = now - self._t0
        tclass = self._target_class(target)
        total = 0.0
        for p in self.config.latency:
            if not (p.get("start", 0.0) <= t < p.get("end", float("inf"))):
                continue
            if not self._link_matches(p, target, tclass):
                continue
            with self._lock:
                if self._lat_rng.random() >= p.get("prob", 1.0):
                    continue
                dist = p.get("dist", "uniform")
                if dist == "exp":
                    d = self._lat_rng.expovariate(
                        1.0 / max(1e-6, float(p.get("mean", 0.05))))
                elif dist == "lognormal":
                    d = self._lat_rng.lognormvariate(
                        float(p.get("mu", -3.5)),
                        float(p.get("sigma", 0.5)))
                else:
                    lo = float(p.get("lo", 0.01))
                    hi = float(p.get("hi", max(0.05, lo)))
                    d = lo + self._lat_rng.random() * (hi - lo)
            total += min(d, float(p.get("cap", 5.0)))
        return total

    # -------------------------------------------------------------- plan
    def plan_send(self, target: Optional[bytes], mtype: bytes,
                  payload: Any) -> List[Tuple[float, Any]]:
        """Decide the fate of one outgoing message. ``target`` is the
        peer identity (``None`` = the controller link). Returns
        ``[(delay_s, payload), ...]``: empty list = dropped, two entries
        = duplicated. Injectable dict payloads are stamped with a wire
        sequence number for receiver-side dedup."""
        name = mtype.decode("ascii", "replace")
        if isinstance(payload, dict) and \
                payload.pop("__chaos_delayed__", None):
            # second pass of a message we already delayed: it was
            # decided once — ship it now. Without this, always-on
            # latency links (prob 1.0) would re-delay on every re-entry
            # and the message would never reach the wire.
            self.stats[("delayed_ship", name)] += 1
            return [(0.0, payload)]
        now = time.monotonic()
        # scheduled partitions cut EVERYTHING on the link, protected
        # types included — a real partition doesn't read headers
        if self.config.partitions and self._partitioned(target, now):
            self.stats[("partition", name)] += 1
            return []
        # slow links delay EVERYTHING too (a congested path doesn't
        # read headers either), protected types included — unlike a cut
        # this is always recoverable by waiting
        link_delay = self._link_delay(target, now)
        if link_delay > 0.0:
            self.stats[("latency", name)] += 1
        if name in PROTECTED_TYPES:
            if link_delay > 0.0 and isinstance(payload, dict):
                payload = dict(payload, __chaos_delayed__=True)
            return [(link_delay, payload)]
        cfg = self.config
        with self._lock:
            if self._severed and (target in self._severed):
                self.stats[("sever", name)] += 1
                return []
            # fixed draw count per message keeps the stream replayable
            r_drop = self._rng.random()
            r_dup = self._rng.random()
            r_delay = self._rng.random()
            r_amount = self._rng.random()
            n = next(self._seq)
        if r_drop < cfg.drop_p(name):
            self.stats[("drop", name)] += 1
            return []
        if isinstance(payload, dict):
            payload = dict(payload, __wseq__=(self._tag, n))
        lo, hi = cfg.delay_range_s
        delay = lo + r_amount * (hi - lo) \
            if r_delay < cfg.delay_p(name) else 0.0
        if delay > 0.0:
            self.stats[("delay", name)] += 1
        delay += link_delay
        delayed = payload
        if delay > 0.0 and isinstance(payload, dict):
            # delayed copies re-enter the transport's send path via a
            # timer; the marker makes the second pass ship-only (the
            # immediate dup below stays unmarked — it never re-enters)
            delayed = dict(payload, __chaos_delayed__=True)
        out = [(delay, delayed)]
        if isinstance(payload, dict) and r_dup < cfg.dup_p(name):
            # the copy carries the SAME wire seq: receivers must drop
            # it. It must be a DISTINCT dict object though: both copies
            # can coalesce into one MSG_BATCH, where pickle's memo
            # would collapse one shared object into one deserialized
            # dict — the first dispatch pops the __wseq__/__rseq__
            # dedup stamps and the second copy then passes both dedups
            # (double-handling instead of a deduped duplicate).
            self.stats[("dup", name)] += 1
            out.append((0.0, dict(payload)))
        return out


def node_identity(node_id_b: bytes) -> bytes:
    """A node manager's wire identity for a given NodeID binary — lets
    tests key partition/latency matrices to concrete nodes
    (``"id:" + node_identity(nid).hex()``)."""
    return b"N" + node_id_b[:27]


def maybe_injector(role: str,
                   self_id: Optional[bytes] = None
                   ) -> Optional[ChaosInjector]:
    """The per-process activation hook: returns an injector when chaos
    env vars are set, else ``None`` (the common case — callers keep a
    ``None`` handle and skip every chaos branch). ``self_id`` is the
    process's wire identity, for concrete-id (``"id:<hexprefix>"``)
    partition/latency matching."""
    cfg = ChaosConfig.from_env()
    if cfg is None:
        return None
    sid = os.environ.get(ENV_STREAM_ID, "")
    stream = f"{role}:{sid}" if sid else role
    inj = ChaosInjector(cfg, stream,
                        self_id=self_id.hex() if self_id else None)
    logger.warning("chaos: fault injection ACTIVE (seed=%d stream=%s)",
                   cfg.seed, stream)
    return inj


def check_dedup(dedup: Optional[SeqDeduper], payload: Any) -> bool:
    """Receiver-side hook: pops the wire seq stamp (and the delayed-ship
    marker, for transports whose parked sends go straight to the wire)
    and returns True when the payload is a duplicate that must be
    discarded."""
    if dedup is None or not isinstance(payload, dict):
        return False
    payload.pop("__chaos_delayed__", None)
    key = payload.pop("__wseq__", None)
    return key is not None and dedup.seen(key)


class DiskFaultInjector:
    """Seeded fault decider for the spill path's disk I/O
    (``native_store.py``). One deterministic stream per process,
    independent of the message-fault draws (``:disk`` suffix), so
    enabling disk faults shifts no message decisions.

    Ops and fault kinds:

    - ``spill_write``: ``"eio"`` | ``"enospc"`` — the spill write is
      refused; the store keeps the object resident (it is still the
      only copy) and retries on a later sweep.
    - ``restore_read``: ``"eio"`` (transient — the store reports
      ``"retry"`` until a strike cap, then declares the local backing
      copy lost) | ``"truncate"`` (a torn file: immediately lost).
    """

    def __init__(self, config: ChaosConfig, stream: str):
        self.config = config
        self.stream = stream
        self._rng = random.Random(f"{config.seed}:{stream}:disk")
        self._lock = threading.Lock()
        self.stats: "collections.Counter" = collections.Counter()

    def fault(self, op: str) -> Optional[str]:
        """Draw the fate of one disk operation: None (healthy) or a
        fault kind. Fixed two draws per call keeps the stream
        replayable."""
        p = self.config.disk_p(op)
        with self._lock:
            r = self._rng.random()
            r_kind = self._rng.random()
        if p <= 0.0 or r >= p:
            return None
        if op == "spill_write":
            kind = "enospc" if r_kind < 0.33 else "eio"
        else:
            kind = "truncate" if r_kind < 0.25 else "eio"
        self.stats[(op, kind)] += 1
        return kind


def maybe_disk_injector(role: str) -> Optional[DiskFaultInjector]:
    """Spill-path activation hook (mirrors :func:`maybe_injector`):
    returns a disk-fault injector when chaos env vars are set with a
    non-zero disk fault mix, else None."""
    cfg = ChaosConfig.from_env()
    if cfg is None or (cfg.disk_fault_prob <= 0.0 and not cfg.disk):
        return None
    sid = os.environ.get(ENV_STREAM_ID, "")
    stream = f"{role}:{sid}" if sid else role
    inj = DiskFaultInjector(cfg, stream)
    logger.warning("chaos: disk-fault injection ACTIVE (seed=%d "
                   "stream=%s)", cfg.seed, stream)
    return inj


class ChaosMonkey:
    """Process-level fault scheduler for tests: SIGKILLs workers and
    node managers mid-task and pauses/restarts the controller, all
    ordered by one seeded PRNG (reference: the chaos/node-killer test
    utils). Operates on the in-process head (``ray_tpu_torch.api._head``) of
    the calling driver."""

    def __init__(self, seed: int, head=None):
        self.rng = random.Random(f"{seed}:monkey")
        self._head = head
        self.log: List[tuple] = []

    def _get_head(self):
        if self._head is not None:
            return self._head
        import ray_tpu_torch.api as api
        return api._head

    # ------------------------------------------------------------ workers
    def worker_pids(self) -> Dict[bytes, int]:
        node = self._get_head().node
        with node._workers_lock:
            return {ident: proc.pid
                    for ident, proc in node.workers.items()}

    def kill_random_worker(self, exclude: Tuple[int, ...] = ()
                           ) -> Optional[int]:
        """SIGKILL one currently-registered worker of the head node,
        chosen deterministically; returns its pid (None if no
        candidates)."""
        pids = self.worker_pids()
        candidates = sorted(p for p in pids.values() if p not in exclude)
        if not candidates:
            return None
        victim = self.rng.choice(candidates)
        self.log.append(("kill_worker", victim))
        try:
            os.kill(victim, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return victim

    def kill_node_proc(self, proc) -> None:
        """SIGKILL a standalone node-manager process (a
        ``cluster_utils`` node's subprocess)."""
        self.log.append(("kill_node", proc.pid))
        try:
            proc.kill()
        except Exception:
            pass

    # --------------------------------------------------------- controller
    def restart_controller(self):
        """kill -9 equivalent for the in-process controller: abandon it
        without any state flush (durability must come from the WAL
        alone) and start a fresh one on the same session."""
        from ray_tpu_torch.core.controller import Controller
        head = self._get_head()
        old = head.controller
        self.log.append(("restart_controller",))
        old._shutdown.set()
        rel = getattr(old, "_reliable", None)
        if rel is not None:
            # a kill -9 takes the retransmit thread with it too
            rel.stop()
        old.wake()
        if old._thread is not None:
            old._thread.join(timeout=10)
        head.controller = Controller(head.session_dir, old.config)
        head.controller.start()
        return head.controller

    def pause_controller(self, seconds: float) -> threading.Thread:
        """Wedge the controller event loop for ``seconds`` (GC-pause /
        overload simulation). Returns the thread holding the loop."""
        head = self._get_head()
        self.log.append(("pause_controller", seconds))

        def hold():
            try:
                head.controller.call_on_loop(
                    lambda: time.sleep(seconds), timeout=seconds + 30.0)
            except Exception:
                pass

        t = threading.Thread(target=hold, name="chaos-pause", daemon=True)
        t.start()
        return t
