"""NodeProvider plugin interface: the port's copy of
``ray_tpu/autoscaler/node_provider.py``.

Reference: ``python/ray/autoscaler/node_provider.py`` (NodeProvider ABC —
create/terminate/list with tag queries, implemented per cloud) and
``python/ray/autoscaler/_private/fake_multi_node/node_provider.py`` (the
fake provider used by the reference's own autoscaler tests, which launches
real raylets on localhost). Node types map to slice hosts, and providers
launch whole node managers (``python -m ray_tpu_torch.core.node``). A
host's ``GPU`` count becomes the node's ``--num-gpus`` (CUDA devices are
the port's ``GPU`` resource); the port's node has no ``--num-tpus``, so a
``TPU`` entry stays a plain custom resource. The cloud providers are
``gce.py`` and ``gke.py``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


class SliceCapacityError(RuntimeError):
    """The provider cannot admit another slice right now (stockout,
    quota, or a configured cap): the caller keeps its demand pending
    and retries on a later reconcile pass."""


class NodeProvider:
    """Minimal provider contract the autoscaler drives."""

    def __init__(self, provider_config: Dict[str, Any]):
        self.provider_config = provider_config

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_resources(self, node_id: str) -> Dict[str, float]:
        raise NotImplementedError

    def node_type(self, node_id: str) -> str:
        raise NotImplementedError

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def internal_id(self, node_id: str) -> Optional[bytes]:
        """Cluster NodeID binary for a provider node once it registered,
        None before. Lets the autoscaler join provider inventory with
        controller-side utilization."""
        raise NotImplementedError

    def internal_ids(self, node_id: str) -> List[bytes]:
        """ALL controller NodeIDs belonging to this provider node — a
        multi-host TPU slice maps one provider node to one NodeID per
        host VM. Default: the single-id contract."""
        one = self.internal_id(node_id)
        return [one] if one is not None else []

    def expected_internal_count(self, node_id: str) -> int:
        """How many cluster nodes this provider node contributes when
        fully joined (host VMs of a slice). The autoscaler treats the
        node as still starting until that many have registered."""
        return 1

    # ---- slice-granular API: the gang unit (reference: one Cloud TPU
    # pod slice = one atomic multi-host allocation) ----
    def create_slice(self, slice_type: str, topology: str = "",
                     host_resources: Optional[Dict[str, float]] = None
                     ) -> str:
        """Atomically request a whole multi-host slice; returns its
        provider id. All host VMs come up together or the create
        raises (never a partial slice). Default contract: one provider
        node IS one slice (the gce.py/gke.py model), so the node API
        carries it. Raises :class:`SliceCapacityError` on stockout."""
        return self.create_node(slice_type, dict(host_resources or {}))

    def delete_slice(self, slice_id: str) -> None:
        """Release the whole slice — every host VM goes down as a
        unit."""
        self.terminate_node(slice_id)

    def slice_hosts(self, slice_id: str) -> List[str]:
        """Provider-level host handles (VM names / endpoints) of the
        slice, stable across calls."""
        return [slice_id]

    def maintenance_events(self) -> List[dict]:
        """Drain-pending maintenance notices:
        ``[{"slice_id", "kind", "event_id"}, ...]``. Each event is
        reported exactly once; the SliceManager answers with a
        preemption-aware drain."""
        return []


def _launch_local_node(session_dir: str, resources: Dict[str, float],
                       labels: Dict[str, str], cluster_node_id: str,
                       log_name: str) -> subprocess.Popen:
    """Start one REAL node-manager process joining ``session_dir``
    (shared by the fake single-node and slice providers — scaled-up
    nodes genuinely join the cluster and run tasks)."""
    res = dict(resources)
    cpus = res.pop("CPU", 1)
    gpus = res.pop("GPU", 0)
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.node",
           "--session-dir", session_dir,
           "--num-cpus", str(cpus),
           "--resources", json.dumps(res),
           "--labels", json.dumps(labels),
           "--node-id", cluster_node_id,
           "--initial-workers", "0"]
    if gpus:
        cmd += ["--num-gpus", str(gpus)]
    log_dir = os.path.join(session_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ)
    import ray_tpu_torch
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__)))
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [pkg_parent, existing] if p)
    with open(os.path.join(log_dir, f"{log_name}.out"), "ab") as log:
        return subprocess.Popen(
            cmd, env=env, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)


class FakeNodeProvider(NodeProvider):
    """Launches REAL node-manager processes on this host (reference:
    fake_multi_node) — scaled-up nodes genuinely join the cluster and run
    tasks, so autoscaler tests exercise the true join/drain paths."""

    def __init__(self, session_dir: str,
                 provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config or {})
        self.session_dir = session_dir
        self._procs: Dict[str, subprocess.Popen] = {}
        self._meta: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return [nid for nid, p in self._procs.items()
                    if p.poll() is None]

    def node_resources(self, node_id: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._meta[node_id]["resources"])

    def node_type(self, node_id: str) -> str:
        with self._lock:
            return self._meta[node_id]["type"]

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        node_id = f"fake-{node_type}-{uuid.uuid4().hex[:8]}"
        cluster_node_id = os.urandom(28).hex()  # NodeID is 28 bytes
        proc = _launch_local_node(
            self.session_dir, resources,
            {"autoscaler-node-type": node_type},
            cluster_node_id, node_id)
        with self._lock:
            self._procs[node_id] = proc
            self._meta[node_id] = {
                "type": node_type, "resources": resources,
                "cluster_node_id": bytes.fromhex(cluster_node_id),
                "created_at": time.time()}
        return node_id

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            proc = self._procs.pop(node_id, None)
            self._meta.pop(node_id, None)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()

    def internal_id(self, node_id: str) -> Optional[bytes]:
        with self._lock:
            meta = self._meta.get(node_id)
            return meta["cluster_node_id"] if meta else None

    def shutdown(self) -> None:
        for nid in list(self.non_terminated_nodes()):
            self.terminate_node(nid)


class FakeSliceProvider(NodeProvider):
    """Deterministic multi-host TPU-slice provider for tests and the
    local ``ray-tpu up`` round-trip.

    Two modes:

    - ``session_dir`` given: every host VM of a created slice is a
      REAL node-manager subprocess joining the session, labelled with
      the slice id (``ray-tpu-slice-id``), so gang placement, drain
      and preemption tests exercise the true join/death paths. Slice
      state persists to ``<session_dir>/fake_slices.json`` — a
      separate process (``ray-tpu down``) tears the same slices down.
    - ``session_dir=None``: in-memory hosts with synthetic NodeIDs for
      clusterless unit tests of the gang math (no processes at all).

    Creation is atomic: all host VMs launch or none (a mid-launch
    failure rolls the partial slice back). ``max_slices`` in
    ``provider_config`` caps capacity — :class:`SliceCapacityError`
    beyond it is the fake stockout that keeps a slice-spanning gang
    PENDING with no partial leases. Maintenance notices are injected
    directly (:meth:`inject_maintenance`) or scheduled
    deterministically from the chaos config (``ChaosConfig.
    maintenance``: ``{"after_s": t, "slice_index": i}`` fires ``t``
    seconds after provider creation against the i-th created slice)."""

    STATE_FILE = "fake_slices.json"

    def __init__(self, session_dir: Optional[str] = None,
                 provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config or {})
        self.session_dir = session_dir
        self.max_slices = int(self.provider_config.get("max_slices", 8))
        self._lock = threading.Lock()
        #: sid -> {type, topology, hosts: [{host, cluster_node_id,
        #: pid}], index, host_resources, created_at}
        self._slices: Dict[str, dict] = {}
        self._procs: Dict[str, List[subprocess.Popen]] = {}
        #: slice ids THIS instance deleted — reload/persist merges must
        #: not resurrect them from another process's stale write
        self._deleted: set = set()
        self._created = 0
        self._t0 = time.monotonic()
        self._pending_events: List[dict] = []
        self._fired_chaos: set = set()
        self._event_seq = 0
        from ray_tpu_torch.core.chaos import ChaosConfig
        chaos_cfg = ChaosConfig.from_env()
        self._chaos_maintenance = list(
            chaos_cfg.maintenance) if chaos_cfg else []
        if session_dir:
            self._load_state()

    # ------------------------------------------------------- persistence
    def _state_path(self) -> str:
        return os.path.join(self.session_dir, self.STATE_FILE)

    def _load_state(self) -> None:
        try:
            with open(self._state_path()) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        self._slices = data.get("slices", {})
        self._created = data.get("created", len(self._slices))

    def reload_state(self) -> None:
        """Merge slices persisted by ANOTHER process into this
        instance (the head-started SliceManager monitor and a
        ``ray-tpu up`` launcher share one state file from different
        pids): disk wins for slices whose host procs this instance
        doesn't own and didn't itself delete. Called by
        ``SliceManager.adopt_existing`` before every reconcile pass."""
        if not self.session_dir:
            return
        try:
            with open(self._state_path()) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        disk = data.get("slices", {})
        with self._lock:
            deleted = getattr(self, "_deleted", set())
            for sid, meta in disk.items():
                if sid not in self._slices and sid not in deleted:
                    self._slices[sid] = meta
            for sid in list(self._slices):
                if sid not in disk and sid not in self._procs:
                    self._slices.pop(sid)
            self._created = max(self._created,
                                int(data.get("created", 0)))

    def _persist_locked(self) -> None:
        if not self.session_dir:
            return
        tmp = self._state_path() + ".tmp"
        os.makedirs(self.session_dir, exist_ok=True)
        # merge-on-write: keep slices another process persisted (and
        # this instance neither owns nor deleted) instead of clobbering
        # them with our in-memory view
        merged = dict(self._slices)
        deleted = getattr(self, "_deleted", set())
        try:
            with open(self._state_path()) as f:
                disk = json.load(f).get("slices", {})
            for sid, meta in disk.items():
                if sid not in merged and sid not in deleted \
                        and sid not in self._procs:
                    merged[sid] = meta
        except (OSError, ValueError):
            pass
        with open(tmp, "w") as f:
            json.dump({"slices": merged,
                       "created": self._created}, f)
        os.replace(tmp, self._state_path())

    # ------------------------------------------------------------ slices
    def create_slice(self, slice_type: str, topology: str = "2x2",
                     host_resources: Optional[Dict[str, float]] = None
                     ) -> str:
        from ray_tpu_torch.autoscaler.slices import hosts_for_topology
        n_hosts = hosts_for_topology(topology)
        host_resources = dict(host_resources or {"CPU": 1})
        with self._lock:
            if len(self._slices) >= self.max_slices:
                raise SliceCapacityError(
                    f"fake provider at capacity "
                    f"({self.max_slices} slices)")
            index = self._created
            self._created += 1
        sid = f"slice-{slice_type}-{uuid.uuid4().hex[:8]}"
        hosts: List[dict] = []
        procs: List[subprocess.Popen] = []
        try:
            for i in range(n_hosts):
                cluster_node_id = os.urandom(28).hex()
                rec = {"host": f"{sid}-host{i}",
                       "cluster_node_id": cluster_node_id, "pid": None}
                if self.session_dir:
                    proc = _launch_local_node(
                        self.session_dir, host_resources,
                        {"ray-tpu-slice-id": sid,
                         "autoscaler-node-type": slice_type},
                        cluster_node_id, rec["host"])
                    rec["pid"] = proc.pid
                    procs.append(proc)
                hosts.append(rec)
        except Exception:
            # all-or-nothing: a failed host launch rolls the slice back
            for proc in procs:
                try:
                    proc.kill()
                except Exception:
                    pass
            raise
        with self._lock:
            self._slices[sid] = {
                "type": slice_type, "topology": topology,
                "hosts": hosts, "index": index,
                "host_resources": host_resources,
                "created_at": time.time()}
            self._procs[sid] = procs
            self._persist_locked()
        return sid

    def delete_slice(self, slice_id: str) -> None:
        with self._lock:
            meta = self._slices.pop(slice_id, None)
            procs = self._procs.pop(slice_id, [])
            self._deleted.add(slice_id)
            self._persist_locked()
        if meta is None:
            return
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        known = {p.pid for p in procs}
        for rec in meta["hosts"]:
            pid = rec.get("pid")
            if pid and pid not in known:
                # launched by another process (ray-tpu up): signal by pid
                try:
                    os.kill(pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + 5.0
        for proc in procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
        for rec in meta["hosts"]:
            pid = rec.get("pid")
            if pid and pid not in known:
                for _ in range(50):
                    try:
                        os.kill(pid, 0)
                    except ProcessLookupError:
                        break
                    time.sleep(0.1)
                else:
                    try:
                        os.kill(pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass

    def slice_hosts(self, slice_id: str) -> List[str]:
        with self._lock:
            meta = self._slices.get(slice_id)
            return [h["host"] for h in meta["hosts"]] if meta else []

    def kill_host(self, slice_id: str, host_index: int) -> int:
        """Hard-preempt ONE host VM of a slice: SIGKILL the host's
        node-manager process AND every descendant process group (the
        zygote runs in its own session, so workers would otherwise
        outlive their node manager — a real VM death takes all of
        them). Chaos helper for the 3D gang-kill leg; returns the
        node-manager pid killed."""
        with self._lock:
            meta = self._slices.get(slice_id)
            if meta is None:
                raise KeyError(f"unknown slice {slice_id}")
            pid = meta["hosts"][host_index].get("pid")
        if not pid:
            raise RuntimeError(
                f"slice {slice_id} host {host_index} has no pid "
                f"(in-memory mode?)")
        seen, stack = set(), [pid]
        while stack:
            p = stack.pop()
            if p in seen:
                continue
            seen.add(p)
            try:
                import glob
                for f in glob.glob(f"/proc/{p}/task/*/children"):
                    with open(f) as fh:
                        stack.extend(int(c) for c in fh.read().split())
            except OSError:
                pass
        own = os.getpgid(0)
        pgids = set()
        for p in seen:
            try:
                pgids.add(os.getpgid(p))
            except (ProcessLookupError, PermissionError):
                pass
        for pg in pgids - {own}:
            try:
                os.killpg(pg, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        return pid

    # ----------------------------------------------------- node contract
    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._slices)

    def node_type(self, node_id: str) -> str:
        with self._lock:
            meta = self._slices.get(node_id)
        if meta is None:
            raise KeyError(f"unknown provider slice {node_id}")
        return meta["type"]

    def node_resources(self, node_id: str) -> Dict[str, float]:
        with self._lock:
            meta = self._slices.get(node_id)
        if meta is None:
            raise KeyError(f"unknown provider slice {node_id}")
        # slice-level resources: per-host resources times host count
        return {k: v * len(meta["hosts"])
                for k, v in meta["host_resources"].items()}

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        # the autoscaler's node-granular entry maps to a 1-host slice
        return self.create_slice(node_type, "1x1", resources)

    def terminate_node(self, node_id: str) -> None:
        self.delete_slice(node_id)

    def internal_ids(self, node_id: str) -> List[bytes]:
        with self._lock:
            meta = self._slices.get(node_id)
            if meta is None:
                return []
            return [bytes.fromhex(h["cluster_node_id"])
                    for h in meta["hosts"]]

    def internal_id(self, node_id: str) -> Optional[bytes]:
        ids = self.internal_ids(node_id)
        return ids[0] if ids else None

    def expected_internal_count(self, node_id: str) -> int:
        with self._lock:
            meta = self._slices.get(node_id)
            return len(meta["hosts"]) if meta else 1

    # ------------------------------------------------------- maintenance
    def inject_maintenance(self, slice_id: str, delay_s: float = 0.0,
                           kind: str = "maintenance") -> str:
        """Schedule a drain notice for the slice (tests / chaos
        harness); returns the event id."""
        with self._lock:
            self._event_seq += 1
            eid = f"ev-{self._event_seq}"
            self._pending_events.append({
                "slice_id": slice_id, "kind": kind, "event_id": eid,
                "due": time.monotonic() + max(0.0, delay_s)})
        return eid

    def maintenance_events(self) -> List[dict]:
        now = time.monotonic()
        out: List[dict] = []
        with self._lock:
            # chaos-scheduled notices: fire once the clock passes
            # after_s AND the indexed slice exists (a schedule against
            # a not-yet-created slice waits for it)
            by_index = {m["index"]: sid
                        for sid, m in self._slices.items()}
            for i, entry in enumerate(self._chaos_maintenance):
                if i in self._fired_chaos:
                    continue
                if now - self._t0 < float(entry.get("after_s", 0.0)):
                    continue
                sid = by_index.get(int(entry.get("slice_index", 0)))
                if sid is None:
                    continue
                self._fired_chaos.add(i)
                out.append({"slice_id": sid,
                            "kind": entry.get("kind", "maintenance"),
                            "event_id": f"chaos-{i}"})
            still = []
            for ev in self._pending_events:
                if ev["due"] <= now and ev["slice_id"] in self._slices:
                    out.append({k: ev[k] for k in
                                ("slice_id", "kind", "event_id")})
                elif ev["slice_id"] in self._slices:
                    still.append(ev)
            self._pending_events = still
        return out

    def shutdown(self) -> None:
        for sid in list(self.non_terminated_nodes()):
            self.delete_slice(sid)
