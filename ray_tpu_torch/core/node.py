"""Node manager: per-node daemon for worker lifecycle and the object store.

Equivalent of the reference's raylet (``src/ray/raylet/node_manager.cc``)
minus scheduling (which lives in the controller here): it spawns/monitors
worker processes (``worker_pool.h:104``), owns the shared-memory store's
eviction/spill authority (plasma runs inside the raylet in the reference,
``object_manager.cc:32``), serves object push/pull transfers
(``object_manager.h:206``), reports heartbeats, and executes kill/cancel
signals. Runs as a thread inside the head process for the default
single-node ``init()``, or as a standalone process (``python -m
ray_tpu_torch.core.node``) for multi-node clusters and tests (equivalent of
``ray.cluster_utils.Cluster.add_node``).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import zmq

from ray_tpu_torch.core import chaos as CH
from ray_tpu_torch.core import direct as D
from ray_tpu_torch.core import events as EV
from ray_tpu_torch.core import protocol as P
from ray_tpu_torch.core import reliable as RD
from ray_tpu_torch.core.config import Config, get_config
from ray_tpu_torch.core.ids import NodeID, ObjectID, WorkerID
from ray_tpu_torch.core.shm_store import make_client, make_store

logger = logging.getLogger(__name__)

#: how long stop() waits for a process it SIGKILLed to be gone
_KILL_WAIT_S = 10.0
#: how long a spawn that finds the zygote still booting waits for it to
#: listen before it boots a cold interpreter instead. The zygote imports
#: once what each cold worker would import for itself (torch with
#: ``torch._dynamo``: 14 s of a fresh worker's first step on the card's
#: host), so a burst of spawns waits less than it would take to boot
#: cold, and every later spawn is a fork.
_ZYGOTE_BOOT_WAIT_S = 60.0


class _ForkedWorker:
    """Popen-shaped handle over a zygote-forked worker. The process is
    reparented to init (double fork), so liveness is probed via /proc —
    and pinned to the process's START TIME: init reaps these workers
    immediately (no zombie holds the pid, unlike Popen children), so a
    recycled pid would otherwise make a dead worker look alive forever
    and let the OOM monitor SIGKILL an unrelated process."""

    @staticmethod
    def _starttime(pid: int) -> Optional[str]:
        """The process's start time, or None once it is gone or a zombie
        (an init that reaps late leaves one behind: it holds no memory,
        no card and no socket, and it runs nothing)."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                parts = f.read().rsplit(") ", 1)[-1].split()
        except OSError:
            return None
        if parts[0] == "Z":
            return None
        return parts[19]  # starttime: field 22, 20th after comm

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._birth = self._starttime(pid)

    def _alive(self) -> bool:
        st = self._starttime(self.pid)
        return st is not None and st == self._birth

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if self._alive():
            return None
        self.returncode = 0
        return 0

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self.returncode or 0

    def terminate(self) -> None:
        if not self._alive():
            self.returncode = 0
            return
        try:
            os.kill(self.pid, signal.SIGTERM)
        except ProcessLookupError:
            self.returncode = 0

    def kill(self) -> None:
        if not self._alive():
            # never signal a recycled pid (could be anyone's process)
            self.returncode = 0
            return
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            self.returncode = 0


class NodeManager:
    def __init__(self, session_dir: str, resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None,
                 node_id: Optional[NodeID] = None,
                 num_initial_workers: int = 0,
                 config: Optional[Config] = None,
                 env: Optional[Dict[str, str]] = None):
        self.session_dir = session_dir
        self.node_id = node_id or NodeID.from_random()
        self.resources = resources
        self.labels = labels or {}
        self.config = config or get_config()
        self.worker_env = env or {}
        # "raytorch-", not the JAX package's "raytpu-": a session of each
        # package in one process must share no shm segment
        self.shm_session = f"raytorch-{os.path.basename(session_dir)}-{self.node_id.hex()[:8]}"

        capacity = self.config.object_store_memory
        if capacity <= 0:
            try:
                import psutil
                capacity = int(psutil.virtual_memory().total
                               * self.config.object_store_memory_fraction)
            except Exception:
                capacity = 2 << 30
        self.store = make_store(
            self.shm_session, capacity,
            spill_dir=os.path.join(self.config.spill_dir, self.node_id.hex()[:8]))
        self.shm = make_client(self.shm_session)

        self.workers: Dict[bytes, subprocess.Popen] = {}  # identity -> proc
        #: pid -> psutil.Process, persistent so cpu_percent deltas work
        self._psutil_cache: Dict[int, Any] = {}
        self._worker_started: Dict[bytes, float] = {}     # identity -> ts
        self._oom_killed: Dict[bytes, bool] = {}          # identity -> True
        self._requested_workers: set = set()   # controller-requested ids
        self._pinned_workers: set = set()      # actor hosts (OOM-deprioritized)
        self._workers_lock = threading.Lock()
        self._stopped = threading.Event()

        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.DEALER)
        # node identity: its NodeID binary (distinct size from WorkerID use
        # is fine — identities are opaque to zmq)
        self.identity = b"N" + self.node_id.binary()[:27]
        self.sock.setsockopt(zmq.IDENTITY, self.identity)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.sock.connect(P.socket_path(session_dir))
        # the heartbeat, retransmit and loop threads send on it, the loop
        # receives from it
        self._ctl_sock = D.SharedSocket(self.ctx, self.sock)
        # direct peer channel: object chunks move node-to-node here and
        # NEVER transit the controller (reference: object_manager.h:206
        # pushes between object managers; GCS sees only locations)
        D.ensure_dir(session_dir)
        self.direct_sock = self.ctx.socket(zmq.ROUTER)
        self.direct_sock.setsockopt(zmq.LINGER, 0)
        self.direct_sock.setsockopt(zmq.SNDHWM, 0)
        self.direct_sock.setsockopt(zmq.RCVHWM, 0)
        self.direct_sock.bind(D.direct_addr(session_dir, self.identity))
        self._peer_socks: Dict[bytes, zmq.Socket] = {}  # loop-thread-only
        self._threads: List[threading.Thread] = []
        self.num_initial_workers = num_initial_workers
        self._incoming: Dict[bytes, dict] = {}
        # pull manager (reference: pull_manager.h:52): bytes-budgeted
        # admission so a burst of pulls can't blow out the local store
        self._pull_queue: List[dict] = []
        self._pulling: Dict[bytes, dict] = {}   # object_id -> pull state
        self._pull_bytes_inflight = 0
        # source-side outbound streams, windowed by receiver acks so a
        # huge object never sits fully buffered in zmq send queues
        self._outgoing: Dict[tuple, dict] = {}  # (requester, oid) -> state
        self._peer_last_used: Dict[bytes, float] = {}
        #: pull retries parked by restore-capacity backoff timers;
        #: drained by the message loop (appends are GIL-atomic)
        self._pull_retries: "deque" = deque()
        from queue import SimpleQueue
        self._store_rpc_q: "SimpleQueue" = SimpleQueue()
        self._store_rpc_thread: Optional[threading.Thread] = None
        #: warm worker factory (see core/zygote.py): forks registered
        #: workers in ~ms instead of seconds of interpreter+import boot
        self._zygote: Optional[subprocess.Popen] = None
        self._zygote_sock = P.unix_socket_name(
            session_dir, f"zygote-{self.node_id.hex()[:12]}.sock")
        #: spawn requests drain on dedicated spawner threads: the
        #: zygote handshake waits for the forked child to be scheduled
        #: once, which under a deep runqueue takes hundreds of ms — it
        #: must never block the node message loop
        self._spawn_q: "SimpleQueue" = SimpleQueue()
        self._spawner_threads: List[threading.Thread] = []
        self._zygote_started = False
        self._spawn_init_lock = threading.Lock()
        self._spawn_count = 0
        # seeded fault injection (chaos.py): None in production
        self._chaos = CH.maybe_injector("node", self_id=self.identity)
        self._chaos_dedup = CH.SeqDeduper() if self._chaos is not None \
            else None
        #: chaos-delayed direct sends (timer threads) and reliable-layer
        #: direct acks parked here; drained by the message loop (peer
        #: sockets are loop-thread-only)
        self._chaos_delayed: "deque" = deque()
        # flight recorder (core/events.py): the node's contribution is
        # transport-health events (retransmits of its PUT announcements,
        # dedup drops); flushed with the heartbeat
        self.recorder = EV.make_recorder(
            f"node:{self.node_id.hex()[:12]}", self.config,
            send=lambda evs: self._send(P.TASK_EVENTS, {"events": evs}))
        # reliable-delivery sublayer: the node's critical one-way
        # traffic is controller-bound (PUT_OBJECT announcements); it
        # also acks the controller's TASK_ASSIGNs
        self._reliable = RD.maybe_transport(
            self.config, self._reliable_resend, self._reliable_ack,
            rng=self._chaos.rng_for("retransmit")
            if self._chaos is not None else None, name="node",
            recorder=self.recorder)
        # fleet metrics reporter: the node manager's registry (store
        # gauges, transport counters) ships with the heartbeat cadence
        from ray_tpu_torch.util import metrics as MX
        self.metrics_reporter = MX.make_reporter(
            lambda payload: self._send(P.METRIC_REPORT, payload),
            {"node": self.node_id.hex()[:12], "pid": os.getpid(),
             "role": "node"},
            self.config,
            pending_drop=(
                (lambda keep: self._reliable.drop_oldest_of(
                    P.METRIC_REPORT, keep))
                if self._reliable is not None else None))

    # ------------------------------------------------------------------ run
    def _register_with_controller(self) -> None:
        self._send(P.REGISTER, {
            "kind": "node", "id": self.identity,
            "node_id": self.node_id.binary(), "resources": self.resources,
            "labels": self.labels, "pid": os.getpid(),
            "objects": self.store.contents()})

    def _worker_base_env(self) -> Dict[str, str]:
        """Env a worker needs beyond the inherited environment."""
        env: Dict[str, str] = dict(self.worker_env)
        env["RAY_TPU_TORCH_SESSION_DIR"] = self.session_dir
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_TORCH_SHM_SESSION"] = self.shm_session
        # zygote-forked workers are reparented to init: the orphan
        # watchdog must poll this pid, not getppid()
        env["RAY_TPU_TORCH_NODE_PID"] = str(os.getpid())
        import ray_tpu_torch
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        extra_paths = [pkg_parent, os.getcwd()]
        existing = os.environ.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in extra_paths
            + ([existing] if existing else []) if p)
        return env

    def _start_zygote(self) -> None:
        """Lazy: launched by the first worker spawn, not node start — a
        many-node virtual cluster (cluster_utils envelope) would
        otherwise pay one zygote interpreter boot per node up front
        (measured: 2x slower node join)."""
        if self._zygote_started:
            return
        self._zygote_started = True
        if not getattr(self.config, "worker_zygote", True):
            return
        env = dict(os.environ)
        env.update(self._worker_base_env())
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(
            log_dir, f"zygote-{self.node_id.hex()[:12]}.out"), "ab")
        try:
            self._zygote = subprocess.Popen(
                [sys.executable, "-u", "-m", "ray_tpu_torch.core.zygote",
                 self._zygote_sock, str(os.getpid())],
                env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        except Exception:
            logger.exception("zygote failed to start; worker spawns "
                             "fall back to cold boots")
            self._zygote = None

    def _zygote_connect(self, z):
        """A connection to the zygote's socket. While the zygote boots
        (alive, not yet listening) this waits for it, up to
        ``_ZYGOTE_BOOT_WAIT_S``; returns None once it is dead or the wait
        is over."""
        import socket as _socket
        deadline = time.monotonic() + _ZYGOTE_BOOT_WAIT_S
        while not self._stopped.is_set():
            conn = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            conn.settimeout(30.0)
            try:
                conn.connect(P.unix_address(self._zygote_sock))
                return conn
            except OSError:
                conn.close()
            if z.poll() is not None or time.monotonic() >= deadline:
                return None
            time.sleep(0.05)
        return None

    def _zygote_spawn(self, env: Dict[str, str],
                      log_path: str) -> Optional[int]:
        """Ask the zygote for a forked worker; returns its pid, or None
        when the zygote isn't usable (dead, disabled, or still booting
        after the wait in :meth:`_zygote_connect`). The zygote forks and
        moves on immediately; the pid arrives from the CHILD once it is
        first scheduled — so this call can wait a while under load and
        must only run on spawner threads."""
        z = self._zygote
        if z is None or z.poll() is not None:
            return None
        import json as _json
        try:
            conn = self._zygote_connect(z)
            if conn is None:
                return None
            try:
                conn.sendall((_json.dumps(
                    {"env": env, "log_path": log_path})
                    + "\n").encode())
                data = b""
                while not data.endswith(b"\n"):
                    chunk = conn.recv(4096)
                    if not chunk:
                        return None
                    data += chunk
            finally:
                conn.close()
            return int(_json.loads(data)["pid"])
        except Exception:
            return None

    def start(self) -> None:
        self._register_with_controller()
        for t in (threading.Thread(target=self._loop, name="node-loop", daemon=True),
                  threading.Thread(target=self._heartbeat_loop, name="node-hb", daemon=True),
                  threading.Thread(target=self._reaper_loop, name="node-reaper", daemon=True),
                  threading.Thread(target=self._memory_monitor_loop,
                                   name="node-memmon", daemon=True)):
            t.start()
            self._threads.append(t)
        for _ in range(self.num_initial_workers):
            self._start_worker(requested=False)

    def stop(self) -> None:
        self._stopped.set()
        if self._reliable is not None:
            self._reliable.stop()
        with self._workers_lock:
            procs = list(self.workers.values())
        for p in procs:
            try:
                p.terminate()
            except Exception:
                pass
        deadline = time.monotonic() + 3
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:
                try:
                    # a worker that holds a card can take seconds to
                    # release it even after SIGKILL: stop() returns once
                    # it is gone, so none outlives the caller
                    p.kill()
                    p.wait(timeout=_KILL_WAIT_S)
                except Exception:
                    pass
        # a spawn in flight registers (and kills) its worker before its
        # thread sees the flag and ends
        for _ in self._spawner_threads:
            self._spawn_q.put(None)          # wakes an idle spawner
        deadline = time.monotonic() + _KILL_WAIT_S
        for t in list(self._spawner_threads):
            if t is not threading.current_thread():
                t.join(timeout=max(0.1, deadline - time.monotonic()))
        if self._zygote is not None:
            try:
                self._zygote.terminate()
                self._zygote.wait(timeout=2)
            except Exception:
                try:
                    self._zygote.kill()
                    self._zygote.wait(timeout=_KILL_WAIT_S)
                except Exception:
                    pass
            if not P.is_abstract(self._zygote_sock):
                try:
                    os.unlink(self._zygote_sock)
                except OSError:
                    pass
        try:
            self._ctl_sock.close()
            self.direct_sock.close(0)
            for s in self._peer_socks.values():
                s.close(0)
            self._peer_socks.clear()
        except Exception:
            pass
        self.shm.close()
        self.store.destroy()

    def _reliable_resend(self, target, mtype: bytes, payload) -> None:
        """Retransmit hook (reliable-layer thread): controller-bound
        messages re-enter _send (chaos filter re-applied; the stamp is
        idempotent); direct-channel resends park for the loop thread."""
        if self._stopped.is_set():
            return
        if target is None:
            self._send(mtype, payload)
        else:
            self._chaos_delayed.append((target, mtype, payload))

    def _reliable_ack(self, route, payload) -> None:
        if self._stopped.is_set():
            return
        if route is None:
            self._send(P.MSG_ACK, payload)
        else:
            self._chaos_delayed.append((route, P.MSG_ACK, payload))

    def _send(self, mtype: bytes, payload) -> None:
        if self._reliable is not None:
            payload = self._reliable.stamp(None, mtype, payload)
        if self._chaos is not None:
            for delay_s, pl in self._chaos.plan_send(None, mtype, payload):
                if delay_s > 0.0:
                    t = threading.Timer(delay_s, self._send_now,
                                        args=(mtype, pl))
                    t.daemon = True
                    t.start()
                else:
                    self._send_now(mtype, pl)
            return
        self._send_now(mtype, payload)

    def _send_now(self, mtype: bytes, payload) -> None:
        if self._stopped.is_set():
            return
        self._ctl_sock.send_multipart([mtype, P.dumps(payload)])

    # ------------------------------------------------------------ messages
    def _loop(self) -> None:
        poller = zmq.Poller()
        self._ctl_sock.register(poller)
        poller.register(self.direct_sock, zmq.POLLIN)
        while not self._stopped.is_set():
            try:
                events = dict(poller.poll(timeout=1000))
            except zmq.ZMQError:
                break
            while self._pull_retries:
                requester, m = self._pull_retries.popleft()
                try:
                    self._start_stream(requester, m)
                except Exception:
                    logger.exception("pull retry failed")
            while self._chaos_delayed:
                # chaos-delayed direct sends: already stamped/planned —
                # ship as-is from the loop thread that owns peer sockets
                target, mtype, pl = self._chaos_delayed.popleft()
                try:
                    self._peer_sock(target).send_multipart(
                        [mtype, P.dumps(pl)])
                except Exception:
                    pass
            # every turn: the socket's descriptor is edge-triggered
            for frames in self._ctl_sock.drain():
                try:
                    self._handle(frames[0], P.loads(frames[1]))
                except Exception:
                    logger.exception("node: error handling %s", frames[0])
            if self.direct_sock in events:
                while True:
                    try:
                        frames = self.direct_sock.recv_multipart(zmq.NOBLOCK)
                    except zmq.ZMQError:
                        break
                    try:
                        # [sender identity, mtype, payload]
                        self._handle_direct(frames[0], frames[1],
                                            P.loads(frames[2]))
                    except Exception:
                        logger.exception("node: error in direct %s",
                                         frames[1])
            self._check_pull_timeouts()

    def _peer_sock(self, target: bytes) -> "zmq.Socket":
        """Loop-thread-only: lazily connected DEALER to a peer node's
        direct ROUTER."""
        s = self._peer_socks.get(target)
        if s is None:
            s = self.ctx.socket(zmq.DEALER)
            s.setsockopt(zmq.IDENTITY, self.identity)
            s.setsockopt(zmq.LINGER, 0)
            s.setsockopt(zmq.SNDHWM, 0)
            s.connect(D.direct_addr(self.session_dir, target))
            self._peer_socks[target] = s
        self._peer_last_used[target] = time.monotonic()
        return s

    def _send_direct(self, target: bytes, mtype: bytes, payload) -> None:
        if self._chaos is not None:
            for delay_s, pl in self._chaos.plan_send(target, mtype,
                                                     payload):
                if delay_s > 0.0:
                    # peer sockets are loop-thread-only: the timer parks
                    # the send; the loop drains it on its next wakeup
                    t = threading.Timer(
                        delay_s, self._chaos_delayed.append,
                        args=((target, mtype, pl),))
                    t.daemon = True
                    t.start()
                else:
                    self._peer_sock(target).send_multipart(
                        [mtype, P.dumps(pl)])
            return
        self._peer_sock(target).send_multipart([mtype, P.dumps(payload)])

    def _prune_peer_socks(self, idle_s: float = 120.0) -> None:
        now = time.monotonic()
        for target in [t for t, used in self._peer_last_used.items()
                       if now - used > idle_s]:
            self._peer_last_used.pop(target, None)
            s = self._peer_socks.pop(target, None)
            if s is not None:
                try:
                    s.close(0)
                except Exception:
                    pass

    def _handle(self, mtype: bytes, m: dict) -> None:
        if self._chaos_dedup is not None and CH.check_dedup(
                self._chaos_dedup, m):
            return  # injected duplicate of a message already handled
        if self._reliable is not None:
            if mtype == P.MSG_ACK:
                self._reliable.on_ack(m)
                return
            if self._reliable.on_receive(None, m):
                return  # retransmit duplicate of a handled message
        if mtype == P.MSG_BATCH:
            for sub_type, sub_payload in m["msgs"]:
                try:
                    self._handle(sub_type, sub_payload)
                except Exception:
                    logger.exception("node: error in batched %s", sub_type)
            return
        if mtype == P.TASK_ASSIGN:
            if m.get("start_worker"):
                self._start_worker(requested=True)
        elif mtype == P.FREE_OBJECT:
            oid = ObjectID(m["object_id"])
            self.shm.release(oid)
            self.store.delete(oid)
        elif mtype == P.LOCATE_OBJECT:
            # directory-repair probe: a producer died before its
            # TASK_DONE reported this object, but the bytes are here
            oid = ObjectID(m["object_id"])
            if self.store.contains(oid):
                state, _, size = self.store.seg.lookup(oid) \
                    if hasattr(self.store, "seg") else (2, 0, 0)
                self._send(P.PUT_OBJECT, {
                    "object_id": m["object_id"],
                    "node_id": self.node_id.binary(),
                    "size": size})
        elif mtype == P.PULL_OBJECT:
            self._enqueue_pull(m)
        elif mtype == P.CANCEL_TASK:
            pid = m.get("pid")
            if pid:
                try:
                    os.kill(pid, signal.SIGKILL if m.get("force") else signal.SIGINT)
                except ProcessLookupError:
                    pass
        elif mtype == P.KILL_ACTOR:
            pid = m.get("pid")
            if pid:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        elif mtype == P.WORKER_PINNED:
            self._pinned_workers.add(m["worker_identity"])
        elif mtype == P.RECONNECT:
            # controller restarted: re-announce this node + its objects,
            # and relay to our workers over their direct channels (the
            # fresh ROUTER cannot address them until they speak first)
            self._register_with_controller()
            with self._workers_lock:
                worker_ids = list(self.workers.keys())
            for wid in worker_ids:
                try:
                    self._send_direct(wid, P.RECONNECT, {})
                except Exception:
                    pass
        elif mtype == P.SHUTDOWN:
            self._stopped.set()

    # ------------------------------------------------------------- workers
    def _start_worker(self, requested: bool = True) -> None:
        """Queue a worker spawn for the spawner threads — the zygote
        handshake waits for the forked child's first schedule, which
        must never stall the caller (message loop / heartbeat)."""
        with self._spawn_init_lock:
            # main thread (initial workers) and node-loop thread
            # (controller TASK_ASSIGN) race here on first spawn
            self._spawn_count += 1
            if not self._spawner_threads:
                for i in range(4):
                    t = threading.Thread(target=self._spawner_loop,
                                         name=f"node-spawner-{i}",
                                         daemon=True)
                    t.start()
                    self._spawner_threads.append(t)
            if self._spawn_count > self.num_initial_workers:
                # demand outgrew the initial pool (an actor burst or a
                # scale-up): the warm factory pays for itself from here,
                # and the spawns that find it booting wait for it
                # (_ZYGOTE_BOOT_WAIT_S). Clusters that never spawn past
                # their initial pool never boot it.
                self._start_zygote()
            spawn_idx = self._spawn_count
        self._spawn_q.put((requested, spawn_idx))

    def _spawner_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                item = self._spawn_q.get(timeout=1.0)
            except Exception:
                continue
            if item is None:
                continue
            requested, spawn_idx = item
            try:
                self._spawn_one(requested, spawn_idx)
            except Exception:
                logger.exception("worker spawn failed")

    def _spawn_one(self, requested: bool, spawn_idx: int = 0) -> None:
        worker_id = WorkerID.from_random()
        delta = self._worker_base_env()
        delta["RAY_TPU_TORCH_WORKER_ID"] = worker_id.hex()
        if self._chaos is not None:
            # stable chaos stream id: the Nth worker this node spawns
            # draws the same fault decisions on every replay (worker
            # ids are random and would de-correlate seeds)
            delta[CH.ENV_STREAM_ID] = str(spawn_idx)
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(
            log_dir, f"worker-{worker_id.hex()[:12]}.out")
        # warm path: fork from the zygote (~ms). Cold fallback: full
        # interpreter boot (zygote still starting, crashed, or disabled)
        pid = self._zygote_spawn(delta, log_path)
        if pid is not None:
            proc = _ForkedWorker(pid)
        else:
            env = dict(os.environ)
            env.update(delta)
            out = open(log_path, "ab")
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m", "ray_tpu_torch.core.worker"],
                env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        self._register_worker(worker_id, proc, requested)

    def _register_worker(self, worker_id: WorkerID, proc,
                         requested: bool) -> None:
        """Track a spawned worker. A spawn that was in flight when
        ``stop()`` took its list of workers is killed here: ``stop()``
        sets the flag before it takes the list, so every worker is
        killed by one of the two (an orphan would otherwise live on
        until its watchdog sees this process gone)."""
        with self._workers_lock:
            self.workers[worker_id.binary()] = proc
            self._worker_started[worker_id.binary()] = time.monotonic()
            if requested:
                # controller-requested: its starting_workers count must be
                # repaired if this worker dies before registering
                self._requested_workers.add(worker_id.binary())
            stopped = self._stopped.is_set()
        if stopped:
            try:
                proc.kill()
                proc.wait(timeout=_KILL_WAIT_S)
            except Exception:
                pass

    def _reaper_loop(self) -> None:
        while not self._stopped.wait(0.5):
            dead = []
            with self._workers_lock:
                for identity, proc in list(self.workers.items()):
                    if proc.poll() is not None:
                        dead.append(identity)
                        del self.workers[identity]
                        self._worker_started.pop(identity, None)
                        self._pinned_workers.discard(identity)
            for identity in dead:
                self._send(P.WORKER_EXIT, {
                    "worker_identity": identity,
                    "node_id": self.node_id.binary(),
                    "requested": identity in self._requested_workers,
                    "reason": "oom"
                    if self._oom_killed.pop(identity, False) else None})
                self._requested_workers.discard(identity)

    # ------------------------------------------------------- OOM defense
    def _memory_fraction(self) -> Optional[float]:
        try:
            import psutil
            return psutil.virtual_memory().percent / 100.0
        except Exception:
            return None

    def _memory_monitor_loop(self) -> None:
        """Reference: MemoryMonitor (memory_monitor.h:52) polls node
        usage; above the threshold a worker is killed by policy. The
        policy here is the reference's LIFO heuristic
        (worker_killing_policy.h:34 — newest-started worker loses the
        least progress; its task is failed as retriable OOM so the
        scheduler can re-run it when pressure clears)."""
        threshold = self.config.memory_usage_threshold
        if threshold <= 0:
            return
        try:
            import psutil  # noqa: F401
        except ImportError:
            logger.warning("psutil unavailable: OOM defense disabled")
            return
        period = self.config.memory_monitor_refresh_ms / 1000.0
        breaches = 0
        while not self._stopped.wait(period):
            frac = self._memory_fraction()
            if frac is None:
                continue  # transient read failure; keep monitoring
            if frac <= threshold:
                breaches = 0
                continue
            breaches += 1
            if breaches < self.config.memory_monitor_breaches:
                continue
            breaches = 0
            self._kill_one_worker_for_oom(frac)

    def _kill_one_worker_for_oom(self, frac: float) -> None:
        now = time.monotonic()
        with self._workers_lock:
            # workers still booting (interpreter + imports take seconds)
            # haven't had a chance to take work — killing them reclaims
            # nothing and can starve the cluster into never executing
            # anything
            candidates = [w for w in self.workers
                          if now - self._worker_started.get(w, now) > 5.0]
            if not candidates:
                return
            # stateless task workers go before actor hosts (reference:
            # worker_killing_policy prefers retriable work — killing an
            # actor loses its state for the same reclaimed bytes)
            task_workers = [w for w in candidates
                            if w not in self._pinned_workers]
            pool = task_workers or candidates

            def rss(w):
                try:
                    import psutil
                    return psutil.Process(self.workers[w].pid) \
                        .memory_info().rss
                except Exception:
                    return 0
            # newest first in 10s buckets (loses least progress), actual
            # RSS breaking ties toward the memory hog
            victim = max(pool, key=lambda w: (
                int(self._worker_started.get(w, 0.0) // 10), rss(w)))
            proc = self.workers[victim]
            self._oom_killed[victim] = True
        logger.warning(
            "memory usage %.0f%% above threshold %.0f%%: killing newest "
            "worker %s (pid %s)", frac * 100,
            self.config.memory_usage_threshold * 100,
            victim[:6].hex(), proc.pid)
        try:
            proc.kill()
        except Exception:
            pass

    def _collect_process_stats(self) -> list:
        """Per-process CPU/RSS of this node's workers + the node manager
        itself (reference: dashboard/modules/reporter/reporter_agent.py
        publishes per-process psutil stats from every node). psutil's
        cpu_percent needs a persistent Process handle between calls, so
        handles are cached by pid."""
        try:
            import psutil
        except ImportError:
            return []
        cache = self._psutil_cache
        with self._workers_lock:
            entries = [(w.hex(), "worker", p.pid)
                       for w, p in self.workers.items()
                       if p.poll() is None]
        entries.append(("", "node_manager", os.getpid()))
        out = []
        for ident, kind, pid in entries:
            try:
                pr = cache.get(pid)
                if pr is None:
                    pr = cache[pid] = psutil.Process(pid)
                    pr.cpu_percent(interval=None)  # prime the counter
                mi = pr.memory_info()
                out.append({
                    "worker_id": ident, "kind": kind, "pid": pid,
                    "cpu_percent": pr.cpu_percent(interval=None),
                    "rss": mi.rss,
                    "num_threads": pr.num_threads(),
                })
            except Exception:
                cache.pop(pid, None)
        for pid in [p for p in cache
                    if p not in {e[2] for e in entries}]:
            del cache[pid]
        return out

    def _heartbeat_loop(self) -> None:
        period = self.config.health_check_period_ms / 1000.0
        beat = 0
        while not self._stopped.wait(period):
            beat += 1
            # Native store: reclaim read-references held by dead PIDs
            # (plasma's disconnected-client cleanup).
            reap = getattr(self.store, "reap_dead_readers", None)
            if reap is not None:
                try:
                    reap()
                except Exception:
                    pass
            # background spill/eviction toward the budget: local creates
            # never notify this authority, so without a periodic sweep
            # the segment drifts to its physical ceiling and every
            # foreground create stalls behind a make_room RPC
            try:
                self.store.maybe_evict()
            except Exception:
                pass
            stats = self.store.stats()
            try:
                import psutil
                stats["mem_percent"] = psutil.virtual_memory().percent
            except Exception:
                pass
            if beat % 5 == 0:
                # per-process stats every 5th beat: psutil walks /proc,
                # which is too costly for the 1s heartbeat itself
                try:
                    stats["processes"] = self._collect_process_stats()
                except Exception:
                    pass
            try:
                from ray_tpu_torch.core.metric_defs import update_from_state
                update_from_state(store_stats=stats, node_stats=stats)
            except Exception:
                pass
            self._send(P.HEARTBEAT, {
                "node_id": self.node_id.binary(), "stats": stats})
            self.recorder.maybe_flush()
            self.metrics_reporter.maybe_report()

    # ----------------------------------------------------------- transfers
    # Receiving side drives (reference: pull_manager.h:52 — the puller
    # admits work against a byte budget); the controller only names the
    # source. Chunks ride the direct node-to-node channel.
    def _handle_direct(self, sender: bytes, mtype: bytes, m: dict) -> None:
        if self._chaos_dedup is not None and CH.check_dedup(
                self._chaos_dedup, m):
            return  # injected duplicate of a message already handled
        if self._reliable is not None:
            if mtype == P.MSG_ACK:
                self._reliable.on_ack(m)
                return
            if self._reliable.on_receive(sender, m):
                return
        if mtype == P.MSG_BATCH:
            # a peer's flusher can coalesce several direct messages
            # (e.g. concurrent STORE_RPCs) into one batch frame
            for sub_type, sub_payload in m["msgs"]:
                try:
                    self._handle_direct(sender, sub_type, sub_payload)
                except Exception:
                    logger.exception("node: error in batched direct %s",
                                     sub_type)
            return
        if mtype == P.STORE_RPC:
            # spill/restore move megabytes through disk: never on the
            # message loop (it also carries heartbeats and transfers).
            # One long-lived maintenance thread drains these — under
            # store pressure every blocked worker polls frequently, and
            # a thread per request would churn exactly then.
            if self._store_rpc_thread is None:
                self._store_rpc_thread = threading.Thread(
                    target=self._store_rpc_loop, name="node-store-rpc",
                    daemon=True)
                self._store_rpc_thread.start()
            self._store_rpc_q.put((sender, m))
        elif mtype == P.PULL_REQUEST:
            self._start_stream(sender, m)
        elif mtype == P.PUSH_OBJECT:
            self._receive_push(sender, m)
        elif mtype == P.CHUNK_ACK:
            self._on_chunk_ack(sender, m)
        elif mtype == P.PULL_FAILED:
            # the SOURCE says the object is gone there: stale location
            self._pull_failed(m["object_id"], m.get("src_node"),
                              stale_src=True)

    def _requeue_pull_request(self, requester: bytes, m: dict) -> None:
        # timer thread: park the retry; the message loop drains it on
        # its next wakeup (loop thread owns all stream/peer state)
        self._pull_retries.append((requester, m))

    def _store_rpc_loop(self) -> None:
        #: reply sockets cached per sender (this thread only)
        reply_socks: Dict[bytes, zmq.Socket] = {}
        while not self._stopped.is_set():
            try:
                sender, m = self._store_rpc_q.get(timeout=1.0)
            except Exception:
                continue
            try:
                self._store_rpc(sender, m, reply_socks)
            except Exception:
                logger.exception("store rpc failed")

    def _store_rpc(self, sender: bytes, m: dict,
                   reply_socks: Optional[Dict[bytes, "zmq.Socket"]]
                   = None) -> None:
        """Worker-requested store maintenance (reference: plasma's
        create-request queue + spilled-object restore requests run in
        the store owner, not the client)."""
        op = m.get("op")
        out: dict = {}
        try:
            if op == "make_room":
                out["freed"] = self.store.make_room(
                    int(m.get("bytes", 0)))
            elif op == "restore":
                oid = ObjectID(m["object_id"])
                try:
                    result = self.store.maybe_restore(
                        oid, for_pid=m.get("pid"))
                except TypeError:
                    # python-store fallback without lease support
                    result = self.store.maybe_restore(oid)
                out["ok"] = result is True
                out["leased"] = result is True and bool(m.get("pid")) \
                    and hasattr(self.store, "seg")
                # capacity-full restores are transient (see
                # NativeShmStore.maybe_restore): tell the caller to
                # retry instead of giving up
                out["retry"] = result == "retry"
                if result == "lost":
                    # the local backing copy is unusable (disk faults /
                    # truncation): report ourselves as a stale holder so
                    # the controller prunes the location and re-pulls
                    # from another holder / reconstructs via lineage
                    self._send(P.PULL_FAILED, {
                        "object_id": m["object_id"],
                        "src_node": self.node_id.binary(),
                        "stale_src": True})
            else:
                out["error"] = f"unknown store op {op!r}"
        except Exception as e:  # noqa: BLE001
            out["error"] = str(e)
        # maintenance thread (not the message loop): _peer_socks is
        # loop-thread-only, so reply over this thread's own cached
        # DEALER per sender. Unique identity: reusing the node's fixed
        # identity would collide with its persistent DEALER to the same
        # worker ROUTER and the reply would be silently dropped.
        sock = None if reply_socks is None else reply_socks.get(sender)
        if sock is None:
            sock = self.ctx.socket(zmq.DEALER)
            sock.setsockopt(zmq.IDENTITY,
                            self.identity[:8] + os.urandom(8))
            sock.setsockopt(zmq.LINGER, 1000)
            sock.connect(D.direct_addr(self.session_dir, sender))
            if reply_socks is not None:
                reply_socks[sender] = sock
                while len(reply_socks) > 256:
                    old, s_old = next(iter(reply_socks.items()))
                    del reply_socks[old]
                    s_old.close(0)
        try:
            sock.send_multipart([P.GENERIC_REPLY, P.dumps(
                {"rid": m.get("rid"), "data": out})])
        finally:
            if reply_socks is None:
                sock.close()

    def _enqueue_pull(self, m: dict) -> None:
        b = m["object_id"]
        if b in self._pulling or self.store.contains(ObjectID(b)):
            return
        self._pull_queue.append(m)
        self._drain_pull_queue()

    def _drain_pull_queue(self) -> None:
        budget = self.config.max_inflight_pull_bytes
        while self._pull_queue:
            m = self._pull_queue[0]
            size = max(1, int(m.get("size") or 1))
            if self._pulling and \
                    self._pull_bytes_inflight + size > budget:
                return  # admission: wait for an in-flight pull to finish
            self._pull_queue.pop(0)
            b = m["object_id"]
            if b in self._pulling or self.store.contains(ObjectID(b)):
                continue
            self._pulling[b] = {
                "src_identity": m["src_identity"], "src_node": m.get("src_node"),
                "size": size, "deadline": time.monotonic() +
                self.config.pull_timeout_s}
            self._pull_bytes_inflight += size
            self._send_direct(m["src_identity"], P.PULL_REQUEST,
                              {"object_id": b})

    def _finish_pull(self, b: bytes) -> None:
        st = self._pulling.pop(b, None)
        if st is not None:
            self._pull_bytes_inflight -= st["size"]
        self._drain_pull_queue()

    def _abort_incoming(self, b: bytes) -> None:
        """Drop a partial in-flight assembly so a later retry can create
        the allocation afresh (a half-written unsealed extent would make
        every retry fail at shm.create)."""
        st = self._incoming.pop(b, None)
        if st is not None:
            oid = ObjectID(b)
            try:
                self.shm.release(oid)
            except Exception:
                pass
            try:
                self.shm.delete(oid)
            except Exception:
                pass
            try:
                self.store.delete(oid)
            except Exception:
                pass

    def _pull_failed(self, b: bytes, src_node, stale_src: bool) -> None:
        if b not in self._pulling and b not in self._incoming:
            return  # late failure for a pull already finished/aborted
        self._abort_incoming(b)
        self._finish_pull(b)
        # stale_src=True only when the SOURCE reported the object missing;
        # dest-local causes (timeout, store pressure) must not make the
        # controller discard a perfectly good holder
        self._send(P.PULL_FAILED, {"object_id": b, "src_node": src_node,
                                   "stale_src": stale_src})

    def _check_pull_timeouts(self) -> None:
        now = time.monotonic()
        if self._pulling:
            for b, st in list(self._pulling.items()):
                if now > st["deadline"]:
                    logger.warning("pull of %s timed out",
                                   ObjectID(b).hex()[:12])
                    self._pull_failed(b, st.get("src_node"),
                                      stale_src=False)
        if self._outgoing:
            for key, st in list(self._outgoing.items()):
                if now - st["last_activity"] > self.config.pull_timeout_s:
                    self._close_stream(key)
        self._prune_peer_socks()

    # Source side (reference: ObjectManager::Push): windowed streaming —
    # at most stream_window_chunks unacked chunks per stream, so a huge
    # object never sits fully buffered in the sender's zmq queue and the
    # loop thread is never blocked for the whole object.
    def _start_stream(self, requester: bytes, m: dict) -> None:
        b = m["object_id"]
        oid = ObjectID(b)
        restored = self.store.maybe_restore(oid)
        view = self.shm.get_view(oid, timeout=2.0) \
            if restored is True else None
        if view is None and restored == "retry" and \
                m.get("_restore_tries", 0) < 20:
            # transient capacity pressure (segment full of reader-held
            # extents): the on-disk copy EXISTS — reporting PULL_FAILED
            # would make the controller drop the only holder. Re-try
            # shortly instead (off-loop timer; the message loop must
            # not sleep).
            m = dict(m, _restore_tries=m.get("_restore_tries", 0) + 1)
            t = threading.Timer(0.5, self._requeue_pull_request,
                                args=(requester, m))
            t.daemon = True
            t.start()
            return
        if view is None:
            logger.warning("pull for missing object %s", oid.hex()[:12])
            self._send_direct(requester, P.PULL_FAILED, {
                "object_id": b, "src_node": self.node_id.binary()})
            return
        chunk = self.config.transfer_chunk_bytes
        total = len(view)
        st = {
            "oid": oid, "view": view, "total": total,
            "nchunks": max(1, (total + chunk - 1) // chunk),
            "next_seq": 0, "unacked": 0,
            "last_activity": time.monotonic(),
        }
        self._outgoing[(requester, b)] = st
        self._pump_stream(requester, b, st)

    def _pump_stream(self, requester: bytes, b: bytes, st: dict) -> None:
        chunk = self.config.transfer_chunk_bytes
        window = self.config.stream_window_chunks
        while st["next_seq"] < st["nchunks"] and st["unacked"] < window:
            i = st["next_seq"]
            part = bytes(st["view"][i * chunk:(i + 1) * chunk])
            self._send_direct(requester, P.PUSH_OBJECT, {
                "object_id": b, "seq": i, "nchunks": st["nchunks"],
                "total": st["total"], "data": part})
            st["next_seq"] += 1
            st["unacked"] += 1
        st["last_activity"] = time.monotonic()
        if st["next_seq"] >= st["nchunks"] and st["unacked"] <= 0:
            self._close_stream((requester, b))

    def _on_chunk_ack(self, sender: bytes, m: dict) -> None:
        key = (sender, m["object_id"])
        st = self._outgoing.get(key)
        if st is None:
            return
        st["unacked"] -= m.get("n", 1)
        self._pump_stream(sender, m["object_id"], st)

    def _close_stream(self, key: tuple) -> None:
        st = self._outgoing.pop(key, None)
        if st is not None:
            self.shm.release(st["oid"])

    def _receive_push(self, sender: bytes, m: dict) -> None:
        """Destination side: assemble chunks, seal, announce location."""
        b = m["object_id"]
        oid = ObjectID(b)
        # flow control: ack regardless of outcome so the source's window
        # drains even for duplicate/late chunks
        self._send_direct(sender, P.CHUNK_ACK, {"object_id": b, "n": 1})
        if self.store.contains(oid):
            self._finish_pull(b)
            return
        pull = self._pulling.get(b)
        if pull is None or sender != pull["src_identity"]:
            # no active pull from this source (it timed out / was retried
            # from elsewhere): ignoring the chunk also prevents orphan
            # partial allocations nobody would ever complete
            return
        st = self._incoming.get(b)
        if st is None:
            view = self.shm.create(oid, m["total"])
            st = {"view": view, "seqs": set()}
            self._incoming[b] = st
        chunk = self.config.transfer_chunk_bytes
        off = m["seq"] * chunk
        data = m["data"]
        st["view"][off:off + len(data)] = data
        # distinct-seq tracking: duplicate deliveries (source retry after
        # a timeout race) must not count toward completion
        st["seqs"].add(m["seq"])
        if pull is not None:
            pull["deadline"] = time.monotonic() + self.config.pull_timeout_s
        if len(st["seqs"]) >= m["nchunks"]:
            self.shm.seal(oid)
            try:
                self.store.on_sealed(oid, m["total"], grace=True)
            except TypeError:
                self.store.on_sealed(oid, m["total"])
            del self._incoming[b]
            self._finish_pull(b)
            self._send(P.PUT_OBJECT, {
                "object_id": b, "node_id": self.node_id.binary(),
                "size": m["total"]})

    def run_forever(self) -> None:
        while not self._stopped.wait(0.5):
            pass
        self.stop()


def detect_resources(num_cpus: Optional[float] = None,
                     num_gpus: Optional[float] = None,
                     custom: Optional[Dict[str, float]] = None,
                     memory: Optional[int] = None) -> Dict[str, float]:
    """Build the node resource map (reference:
    ``python/ray/_private/resource_spec.py`` + accelerator detection):
    CPUs, memory, and the CUDA devices as ``GPU``."""
    from ray_tpu_torch.core.accelerators import gpu_count
    res: Dict[str, float] = {}
    res["CPU"] = float(num_cpus if num_cpus is not None else (os.cpu_count() or 1))
    if memory is None:
        try:
            import psutil
            memory = int(psutil.virtual_memory().total * 0.7)
        except Exception:
            memory = 4 << 30
    res["memory"] = float(memory)
    gpus = num_gpus if num_gpus is not None else gpu_count()
    if gpus:
        res[get_config().gpu_resource_name] = float(gpus)
    res.update(custom or {})
    return res


def main() -> None:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--session-dir", required=True)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default="{}")
    p.add_argument("--labels", default="{}")
    p.add_argument("--initial-workers", type=int, default=0)
    p.add_argument("--node-id", default=None,
                   help="hex NodeID (autoscaler providers pre-assign one "
                        "to join provider inventory with cluster state)")
    args = p.parse_args()
    import json
    res = detect_resources(args.num_cpus, args.num_gpus,
                           json.loads(args.resources))
    nm = NodeManager(args.session_dir, res, labels=json.loads(args.labels),
                     node_id=NodeID.from_hex(args.node_id)
                     if args.node_id else None,
                     num_initial_workers=args.initial_workers)
    nm.start()
    nm.run_forever()


if __name__ == "__main__":
    main()
