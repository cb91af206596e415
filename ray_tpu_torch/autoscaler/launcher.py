"""Cluster launcher: ``cli up / down / attach`` from a YAML config.

Reference: ``python/ray/autoscaler/_private/commands.py`` (``ray up`` —
validate config, create or update head node, bootstrap it over SSH,
start the autoscaler there) with the schema contract of
``python/ray/autoscaler/ray-schema.json``. TPU-native differences: the
provisioning unit is a TPU pod slice (see gce.py), the head is itself a
TPU VM (or an existing address), and bootstrap commands run on every
host VM of a slice via the command runner (reference:
``gcp/tpu_command_runner.py`` fans one runner out per networkEndpoint).

The port's copy of ``ray_tpu/autoscaler/launcher.py``. The local launcher
starts ``python -m ray_tpu_torch.scripts.head`` under the port's session
root (``api.session_root()``, in the temp dir), and waits for the head's
``session.json`` alone: the port's sockets may take abstract names and
leave no file (``core/protocol.py::unix_socket_name``), so it removes a
stale ``session.json`` before it starts a head. The head's node type's
``GPU`` count, where it names one, is the head's ``--num-gpus``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import yaml

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


# --------------------------------------------------------------- schema
class ConfigError(ValueError):
    """Invalid cluster YAML, with the offending path in the message."""


_PROVIDER_REQUIRED = {"gce_tpu": ("project", "zone")}


def validate_cluster_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Validate + normalize a cluster config dict (reference:
    ray-schema.json, scoped to the fields this launcher consumes).
    Returns the config with defaults filled in."""
    if not isinstance(cfg, dict):
        raise ConfigError("cluster config must be a mapping")

    def need(d: dict, key: str, typ, path: str):
        if key not in d:
            raise ConfigError(f"missing required field '{path}{key}'")
        if not isinstance(d[key], typ):
            raise ConfigError(
                f"'{path}{key}' must be {typ.__name__}, "
                f"got {type(d[key]).__name__}")
        return d[key]

    need(cfg, "cluster_name", str, "")
    provider = need(cfg, "provider", dict, "")
    ptype = need(provider, "type", str, "provider.")
    for field in _PROVIDER_REQUIRED.get(ptype, ()):
        need(provider, field, str, "provider.")
    types = need(cfg, "available_node_types", dict, "")
    if not types:
        raise ConfigError("'available_node_types' must not be empty")
    for name, t in types.items():
        if not isinstance(t, dict):
            raise ConfigError(
                f"'available_node_types.{name}' must be a mapping")
        path = f"available_node_types.{name}."
        res = need(t, "resources", dict, path)
        for k, v in res.items():
            if not isinstance(v, (int, float)) or v < 0:
                raise ConfigError(
                    f"'{path}resources.{k}' must be a non-negative "
                    f"number")
        t.setdefault("min_workers", 0)
        t.setdefault("max_workers", cfg.get("max_workers", 8))
        for bound in ("min_workers", "max_workers"):
            if not isinstance(t[bound], int) or t[bound] < 0:
                raise ConfigError(
                    f"'{path}{bound}' must be a non-negative integer")
        if t["min_workers"] > t["max_workers"]:
            raise ConfigError(
                f"'{path}min_workers' ({t['min_workers']}) exceeds "
                f"max_workers ({t['max_workers']})")
        t.setdefault("node_config", {})
        if not isinstance(t["node_config"], dict):
            raise ConfigError(f"'{path}node_config' must be a mapping")
    head_type = need(cfg, "head_node_type", str, "")
    if head_type not in types:
        raise ConfigError(
            f"'head_node_type' {head_type!r} is not one of "
            f"available_node_types {sorted(types)}")
    # ---- slices: the gang units `cli up` brings up whole and the
    # SliceManager scales (autoscaler/slices.py)
    slices = cfg.setdefault("slices", {})
    if not isinstance(slices, dict):
        raise ConfigError("'slices' must be a mapping")
    from ray_tpu_torch.autoscaler.slices import hosts_for_topology
    for name, s in slices.items():
        if not isinstance(s, dict):
            raise ConfigError(f"'slices.{name}' must be a mapping")
        path = f"slices.{name}."
        topo = need(s, "topology", str, path)
        try:
            n_hosts = hosts_for_topology(topo)
        except ValueError as e:
            raise ConfigError(f"'{path}topology': {e}") from None
        s.setdefault("count", 1)
        s.setdefault("min_slices", 0)
        s.setdefault("max_slices", max(int(s.get("count") or 0), 4))
        for bound in ("count", "min_slices", "max_slices"):
            if not isinstance(s[bound], int) or s[bound] < 0:
                raise ConfigError(
                    f"'{path}{bound}' must be a non-negative integer")
        if s["count"] > s["max_slices"]:
            raise ConfigError(
                f"'{path}count' ({s['count']}) exceeds max_slices "
                f"({s['max_slices']})")
        res = s.setdefault("host_resources", {"CPU": 1})
        if not isinstance(res, dict):
            raise ConfigError(f"'{path}host_resources' must be a mapping")
        for k, v in res.items():
            if not isinstance(v, (int, float)) or v < 0:
                raise ConfigError(
                    f"'{path}host_resources.{k}' must be a "
                    f"non-negative number")
        s.setdefault("node_config", {})
        if not isinstance(s["node_config"], dict):
            raise ConfigError(f"'{path}node_config' must be a mapping")
        placement = s.get("placement")
        if placement is not None:
            if not isinstance(placement, dict):
                raise ConfigError(f"'{path}placement' must be a mapping")
            strat = placement.setdefault("strategy", "SLICE_SPREAD")
            if strat not in ("SLICE_PACK", "SLICE_SPREAD"):
                raise ConfigError(
                    f"'{path}placement.strategy' must be SLICE_PACK "
                    f"or SLICE_SPREAD, got {strat!r}")
            bundles = placement.get("bundles")
            if not isinstance(bundles, list) or not bundles or \
                    not all(isinstance(b, dict) for b in bundles):
                raise ConfigError(
                    f"'{path}placement.bundles' must be a non-empty "
                    f"list of resource mappings")
            if strat == "SLICE_SPREAD" and len(bundles) > n_hosts:
                raise ConfigError(
                    f"'{path}placement.bundles': {len(bundles)} "
                    f"bundles exceed the {n_hosts} host VM(s) of "
                    f"topology {topo!r} (SLICE_SPREAD needs one "
                    f"distinct host per bundle)")
    # ---- arbiter: train+serve slice arbitration policy knobs
    # (autoscaler/arbiter.py) the head monitor drives next to the
    # SliceManager
    arbiter = cfg.get("arbiter")
    if arbiter is not None:
        if not isinstance(arbiter, dict):
            raise ConfigError("'arbiter' must be a mapping")
        import dataclasses as _dc

        from ray_tpu_torch.autoscaler.arbiter import ArbiterPolicy
        known = {f.name for f in _dc.fields(ArbiterPolicy)}
        for k, v in arbiter.items():
            if k not in known:
                raise ConfigError(
                    f"'arbiter.{k}' is not a policy knob "
                    f"(one of {sorted(known)})")
            if not isinstance(v, (int, float)) or v < 0:
                raise ConfigError(
                    f"'arbiter.{k}' must be a non-negative number")
    cfg.setdefault("max_workers", 8)
    cfg.setdefault("setup_commands", [])
    cfg.setdefault("head_start_commands", [])
    cfg.setdefault("worker_start_commands", [])
    for key in ("setup_commands", "head_start_commands",
                "worker_start_commands"):
        if not isinstance(cfg[key], list) or \
                not all(isinstance(x, str) for x in cfg[key]):
            raise ConfigError(f"'{key}' must be a list of strings")
    auth = cfg.setdefault("auth", {})
    if not isinstance(auth, dict):
        raise ConfigError("'auth' must be a mapping")
    auth.setdefault("ssh_user", "ray")
    return cfg


def load_cluster_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    return validate_cluster_config(cfg)


# -------------------------------------------------------- command runner
class CommandRunner:
    """Runs bootstrap commands on a cluster host (reference:
    command_runner.py CommandRunnerInterface)."""

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        raise NotImplementedError


class SSHCommandRunner(CommandRunner):
    def __init__(self, ip: str, user: str,
                 ssh_key: Optional[str] = None):
        self.ip = ip
        self.user = user
        self.ssh_key = ssh_key

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        ssh = ["ssh", "-o", "StrictHostKeyChecking=no",
               "-o", "ConnectTimeout=20"]
        if self.ssh_key:
            ssh += ["-i", self.ssh_key]
        ssh += [f"{self.user}@{self.ip}", cmd]
        logger.info("[%s] %s", self.ip, cmd)
        proc = subprocess.run(ssh, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"command failed on {self.ip} (rc={proc.returncode}): "
                f"{cmd}\n{proc.stderr[-2000:]}")
        return proc.stdout


# --------------------------------------------------------------- launcher
def _make_provider(cfg: Dict[str, Any],
                   api=None) -> NodeProvider:
    provider_cfg = dict(cfg["provider"])
    ptype = provider_cfg["type"]
    if ptype == "gce_tpu":
        from ray_tpu_torch.autoscaler.gce import (
            GCETPUNodeProvider, state_resolver)
        from ray_tpu_torch.autoscaler.slices import hosts_for_topology
        provider_cfg["cluster_name"] = cfg["cluster_name"]
        provider_cfg["node_configs"] = {
            name: t.get("node_config", {})
            for name, t in cfg["available_node_types"].items()}
        provider_cfg["resources"] = {
            name: t["resources"]
            for name, t in cfg["available_node_types"].items()}
        # slices are provider nodes too (one node == one slice):
        # slice-level resources = per-host resources x host count
        for name, s in cfg.get("slices", {}).items():
            provider_cfg["node_configs"].setdefault(
                name, s.get("node_config", {}))
            hosts = hosts_for_topology(s["topology"])
            provider_cfg["resources"].setdefault(name, {
                k: v * hosts
                for k, v in s.get("host_resources", {}).items()})
        return GCETPUNodeProvider(provider_cfg, api=api,
                                  resolve_internal=state_resolver())
    if ptype == "fake":
        from ray_tpu_torch.autoscaler.node_provider import FakeNodeProvider
        return FakeNodeProvider(provider_cfg.get("session_dir", "/tmp"),
                                provider_cfg)
    if ptype == "fake_slice":
        from ray_tpu_torch.autoscaler.node_provider import FakeSliceProvider
        return FakeSliceProvider(provider_cfg.get("session_dir"),
                                 provider_cfg)
    raise ConfigError(f"unknown provider type {ptype!r}")


def slice_type_configs(cfg: Dict[str, Any]):
    """The ``slices:`` section of a validated config as
    :class:`~ray_tpu_torch.autoscaler.slices.SliceTypeConfig` rows — what a
    SliceManager scales."""
    from ray_tpu_torch.autoscaler.slices import SliceTypeConfig
    return [
        SliceTypeConfig(
            name,
            topology=s["topology"],
            host_resources=dict(s.get("host_resources", {"CPU": 1})),
            min_slices=int(s.get("min_slices", 0)),
            max_slices=int(s.get("max_slices", 4)))
        for name, s in cfg.get("slices", {}).items()]


def build_slice_manager(controller, cfg: Dict[str, Any],
                        provider: Optional[NodeProvider] = None,
                        idle_timeout_s: float = 3600.0,
                        drain_deadline_s: float = 30.0):
    """Construct the head's SliceManager from a validated cluster
    config — the wiring ``scripts/head`` runs automatically when the
    config has a ``slices:`` section (ROADMAP item 1: tests/drivers no
    longer build it by hand). Returns None when the config defines no
    slice types. Slices already created by the launcher are adopted,
    not re-acquired. The generous default ``idle_timeout_s`` keeps the
    monitor from releasing the ``count:`` slices ``up`` just created
    while a driver is still connecting."""
    types = slice_type_configs(cfg)
    if not types:
        return None
    from ray_tpu_torch.autoscaler.slices import SliceManager
    provider = provider or _make_provider(cfg)
    return SliceManager(controller, provider, types,
                        idle_timeout_s=idle_timeout_s,
                        drain_deadline_s=drain_deadline_s)


def build_slice_arbiter(manager, cfg: Dict[str, Any]):
    """Construct the head's :class:`~ray_tpu_torch.autoscaler.arbiter.
    SliceArbiter` over an already-built SliceManager when the config
    has an ``arbiter:`` section. The arbiter drives the manager's
    reconcile pass itself (``drive_manager=True``), so the head hands
    the ARBITER — not the manager — to its ``AutoscalerMonitor`` and
    one loop does both. Returns None when the config names no arbiter
    (the manager stays the monitor's target, wiring unchanged)."""
    section = cfg.get("arbiter")
    if manager is None or section is None:
        return None
    from ray_tpu_torch.autoscaler.arbiter import ArbiterPolicy, SliceArbiter
    int_knobs = ("min_train_slices", "max_borrowed")
    policy = ArbiterPolicy(**{
        k: (int(v) if k in int_knobs else float(v))
        for k, v in section.items()})
    return SliceArbiter(manager, policy=policy, drive_manager=True)


def node_type_configs(cfg: Dict[str, Any]) -> List[NodeTypeConfig]:
    """Worker node types for the autoscaler: every type but the head."""
    return [
        NodeTypeConfig(name, t["resources"],
                       min_workers=t["min_workers"],
                       max_workers=t["max_workers"])
        for name, t in cfg["available_node_types"].items()
        if name != cfg["head_node_type"]]


class ClusterLauncher:
    """up/down/attach against a validated config. ``runner_factory``
    (ip, user -> CommandRunner) is injectable so tests record commands
    instead of opening SSH connections."""

    def __init__(self, cfg: Dict[str, Any],
                 provider: Optional[NodeProvider] = None,
                 api=None,
                 runner_factory: Optional[
                     Callable[[str, str], CommandRunner]] = None):
        self.cfg = cfg
        self.provider = provider or _make_provider(cfg, api=api)
        self.runner_factory = runner_factory or (
            lambda ip, user: SSHCommandRunner(
                ip, user, cfg["auth"].get("ssh_private_key")))

    # -------------------------------------------------------------- up
    def up(self) -> Dict[str, Any]:
        """Create (or reuse) the head slice, bootstrap every host VM of
        it, start the head daemon + autoscaler (reference:
        commands.get_or_create_head_node)."""
        head_type = self.cfg["head_node_type"]
        head = self._existing_head()
        created = False
        if head is None:
            head = self.provider.create_node(
                head_type,
                self.cfg["available_node_types"][head_type]["resources"])
            created = True
        if hasattr(self.provider, "wait_until_ready"):
            self.provider.wait_until_ready(head)
        endpoints = self._endpoints(head)
        head_ip = endpoints[0] if endpoints else None
        user = self.cfg["auth"]["ssh_user"]
        cmds = list(self.cfg["setup_commands"])
        start = [c.format(head_ip=head_ip or "127.0.0.1",
                          cluster_name=self.cfg["cluster_name"])
                 for c in self.cfg["head_start_commands"]]
        # worker hosts of a multi-host head slice join as workers
        for i, ip in enumerate(endpoints):
            runner = self.runner_factory(ip, user)
            for cmd in cmds + (start if i == 0 else [
                    c.format(head_ip=head_ip, cluster_name=self
                             .cfg["cluster_name"])
                    for c in self.cfg["worker_start_commands"]]):
                runner.run(cmd)
        # bring up the configured gang slices whole (the SliceManager
        # running on the head scales them from there)
        slice_ids: List[str] = []
        if self.cfg.get("slices") and \
                hasattr(self.provider, "create_slice"):
            for name, s in self.cfg["slices"].items():
                for _ in range(int(s.get("count", 1))):
                    slice_ids.append(self.provider.create_slice(
                        name, s.get("topology", ""),
                        s.get("host_resources")))
        logger.info("cluster %s is up (head=%s ip=%s slices=%d)",
                    self.cfg["cluster_name"], head, head_ip,
                    len(slice_ids))
        return {"head_node": head, "head_ip": head_ip,
                "created": created, "slices": slice_ids}

    def _existing_head(self) -> Optional[str]:
        head_type = self.cfg["head_node_type"]
        for nid in self.provider.non_terminated_nodes():
            try:
                if self.provider.node_type(nid) == head_type:
                    return nid
            except KeyError:
                continue
        return None

    def _endpoints(self, node_id: str) -> List[str]:
        if hasattr(self.provider, "host_endpoints"):
            eps = self.provider.host_endpoints(node_id)
            out = []
            for e in eps:
                access = e.get("accessConfig") or {}
                out.append(access.get("externalIp") or e.get("ipAddress"))
            return [ip for ip in out if ip]
        return []

    # ------------------------------------------------------------ down
    def down(self, keep_head: bool = False) -> List[str]:
        """Terminate every provider node of this cluster (reference:
        commands.teardown_cluster; workers first, head last so state
        queries keep working during the drain)."""
        head_type = self.cfg["head_node_type"]
        nodes = self.provider.non_terminated_nodes()
        workers = [n for n in nodes
                   if self._type_of(n) != head_type]
        heads = [n for n in nodes if self._type_of(n) == head_type]
        gone = []
        for nid in workers + ([] if keep_head else heads):
            self.provider.terminate_node(nid)
            gone.append(nid)
        logger.info("cluster %s: terminated %d node(s)",
                    self.cfg["cluster_name"], len(gone))
        return gone

    def _type_of(self, nid: str) -> Optional[str]:
        try:
            return self.provider.node_type(nid)
        except KeyError:
            return None

    # ---------------------------------------------------------- attach
    def attach_command(self) -> List[str]:
        """The ssh invocation for an interactive shell on the head."""
        head = self._existing_head()
        if head is None:
            raise RuntimeError(
                f"cluster {self.cfg['cluster_name']} has no head node; "
                f"run `cli up` first")
        if hasattr(self.provider, "wait_until_ready"):
            self.provider.wait_until_ready(head, timeout_s=60)
        ips = self._endpoints(head)
        if not ips:
            raise RuntimeError(f"head node {head} has no endpoints yet")
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
        key = self.cfg["auth"].get("ssh_private_key")
        if key:
            cmd += ["-i", key]
        cmd.append(f"{self.cfg['auth']['ssh_user']}@{ips[0]}")
        return cmd


# ------------------------------------------------------- local launcher
class LocalClusterLauncher:
    """``cli up/down`` against the LOCAL fake providers: the head
    is a local daemon (``ray_tpu_torch.scripts.head``) and every slice's
    host VMs are local node-manager processes (``FakeSliceProvider``)
    — the zero-cloud round-trip the subprocess tests drive, and the
    laptop-scale way to try gang scheduling end to end.

    State lives under the session dir (``provider.session_dir`` in the
    YAML, default ``<session root>/<cluster_name>``): the head pid in
    ``launcher_state.json`` and the slice inventory in the provider's
    own ``fake_slices.json`` — so ``down`` from a fresh process finds
    everything ``up`` started."""

    STATE_FILE = "launcher_state.json"

    def __init__(self, cfg: Dict[str, Any]):
        self.cfg = cfg
        if not cfg["provider"].get("session_dir"):
            from ray_tpu_torch.api import session_root
        self.session_dir = cfg["provider"].get("session_dir") or \
            os.path.join(session_root(), cfg["cluster_name"])

    def _state_path(self) -> str:
        return os.path.join(self.session_dir, self.STATE_FILE)

    def _load_state(self) -> dict:
        try:
            with open(self._state_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _head_alive(self) -> bool:
        pid = self._load_state().get("head_pid")
        if not pid:
            return False
        try:
            os.kill(pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def _provider(self):
        from ray_tpu_torch.autoscaler.node_provider import FakeSliceProvider
        pcfg = dict(self.cfg["provider"])
        pcfg["session_dir"] = self.session_dir
        return FakeSliceProvider(self.session_dir, pcfg)

    # -------------------------------------------------------------- up
    def up(self, wait_ready_s: float = 30.0) -> Dict[str, Any]:
        os.makedirs(self.session_dir, exist_ok=True)
        head_type = self.cfg["head_node_type"]
        head_res = self.cfg["available_node_types"][head_type][
            "resources"]
        # persist the normalized config where the head daemon (and a
        # later `down` from a fresh process) can find it: the head
        # auto-starts the SliceManager monitor from its slices: section
        cfg_path = os.path.join(self.session_dir, "cluster.yaml")
        cfg_copy = dict(self.cfg)
        cfg_copy["provider"] = dict(self.cfg["provider"],
                                    session_dir=self.session_dir)
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg_copy, f)
        created_head = False
        if not self._head_alive():
            marker = os.path.join(self.session_dir, "session.json")
            if os.path.exists(marker):
                os.remove(marker)   # a stopped head's
            cmd = [sys.executable, "-m", "ray_tpu_torch.scripts.head",
                   "--session-dir", self.session_dir,
                   "--num-cpus", str(head_res.get("CPU", 1)),
                   "--initial-workers", "1",
                   "--cluster-config", cfg_path]
            if head_res.get("GPU"):
                cmd += ["--num-gpus", str(head_res["GPU"])]
            with open(os.path.join(self.session_dir, "head.log"),
                      "ab") as log:
                proc = subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True)
            with open(self._state_path(), "w") as f:
                json.dump({"head_pid": proc.pid}, f)
            created_head = True
            # ready == session.json written (init writes it after the
            # controller's socket is bound)
            deadline = time.monotonic() + wait_ready_s
            while not os.path.exists(marker):
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"head daemon exited rc={proc.returncode} "
                        f"(see {self.session_dir}/head.log)")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"head not ready after {wait_ready_s}s")
                time.sleep(0.1)
        provider = self._provider()
        slice_ids: List[str] = []
        for name, s in self.cfg.get("slices", {}).items():
            for _ in range(int(s.get("count", 1))):
                slice_ids.append(provider.create_slice(
                    name, s["topology"], s.get("host_resources")))
        logger.info("local cluster %s up: session=%s slices=%s",
                    self.cfg["cluster_name"], self.session_dir,
                    slice_ids)
        return {"session_dir": self.session_dir,
                "head_pid": self._load_state().get("head_pid"),
                "created": created_head, "slices": slice_ids}

    # ------------------------------------------------------------ down
    def down(self, keep_head: bool = False) -> Dict[str, Any]:
        provider = self._provider()
        gone = list(provider.non_terminated_nodes())
        for sid in gone:
            provider.delete_slice(sid)
        head_pid = self._load_state().get("head_pid")
        if head_pid and not keep_head:
            try:
                os.kill(head_pid, signal.SIGTERM)
                for _ in range(100):
                    try:
                        # reap if it's our own child, else a zombie
                        # would keep answering signal 0 forever
                        os.waitpid(head_pid, os.WNOHANG)
                    except ChildProcessError:
                        pass
                    os.kill(head_pid, 0)
                    time.sleep(0.1)
                else:
                    os.kill(head_pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                os.remove(self._state_path())
            except OSError:
                pass
        logger.info("local cluster %s down: %d slice(s) terminated",
                    self.cfg["cluster_name"], len(gone))
        return {"terminated": gone, "head_pid": head_pid}


def make_launcher(cfg: Dict[str, Any], **kwargs):
    """The right launcher for the config's provider: local fakes get
    the process-spawning round-trip, clouds get the SSH bootstrap."""
    if cfg["provider"]["type"].startswith("fake"):
        return LocalClusterLauncher(cfg)
    return ClusterLauncher(cfg, **kwargs)
