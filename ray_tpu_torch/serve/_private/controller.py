"""ServeController: the reconciling control plane.

Reference: ``python/ray/serve/_private/controller.py:91``
(``run_control_loop`` :365) + ``deployment_state.py:2462``
(``DeploymentState.update``: reconcile target vs actual replicas) +
``autoscaling_policy.py`` (queue-depth replica autoscaling). One
controller actor owns all deployments of all apps: it starts/stops
replica actors, restarts dead ones, probes queue depth for autoscaling,
and versions replica membership so handles refresh lazily.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._private.replica import Replica

CONTROLLER_NAME = "SERVE_CONTROLLER_ACTOR"


def autoscale_decision(cfg, target_num: int, avg_ongoing: float,
                       avg_queue_depth: Optional[float] = None,
                       avg_ttft_s: Optional[float] = None) -> int:
    """Pure scale policy: the new target replica count for one
    deployment, given the probed signals (delay gating is the
    caller's job — this is the decision, testable without a cluster).

    Scale-up fires on ANY pressure signal: ongoing requests above
    target (the classic queue-depth policy), engine queue depth above
    ``cfg.target_queue_depth``, or engine TTFT above
    ``cfg.target_ttft_s`` (each only when configured AND probed —
    continuous-batching engines admit work immediately, so handle-side
    ongoing counts understate a deep engine backlog). Scale-down
    requires ongoing requests below half target AND no engine
    pressure."""
    up = avg_ongoing > cfg.target_ongoing_requests
    engine_pressure = False
    if cfg.target_queue_depth is not None and avg_queue_depth is not None:
        engine_pressure |= avg_queue_depth > cfg.target_queue_depth
    if cfg.target_ttft_s is not None and avg_ttft_s is not None:
        engine_pressure |= avg_ttft_s > cfg.target_ttft_s
    if (up or engine_pressure) and target_num < cfg.max_replicas:
        return target_num + 1
    if avg_ongoing < cfg.target_ongoing_requests / 2 \
            and not engine_pressure and target_num > cfg.min_replicas:
        return target_num - 1
    return target_num


class _DeploymentInfo:
    def __init__(self, deployment, init_args, init_kwargs):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.target_num = deployment.num_replicas
        self.replicas: List[Any] = []
        self.version = 0
        self.replica_counter = 0
        # delay-gate from DEPLOY time: an epoch-zero stamp would let
        # the first scale decision bypass upscale/downscale_delay_s
        # entirely (observed as a mid-run replica kill the instant
        # engine pressure cleared, ActorDiedError for its streams)
        self._last_scale_up = time.time()
        self._last_scale_down = time.time()


class ServeController:
    def __init__(self):
        self._deployments: Dict[str, _DeploymentInfo] = {}
        self._routes: Dict[str, str] = {}  # route_prefix -> deployment
        self._apps: Dict[str, str] = {}    # app name -> ingress deploy
        # route_prefix -> {"prefill": name, "decode": name}: HTTP
        # ingress for disaggregated pairs (serve/disagg.py) — the proxy
        # drives a DisaggRouter over both fleets instead of a handle
        self._disagg_routes: Dict[str, Dict[str, str]] = {}
        self._lock = threading.RLock()
        # admission config plane: routers poll (seq, policy dict);
        # the dashboard POST endpoint bumps seq on every accepted write
        self._admission_policy: Optional[Dict[str, Any]] = None
        self._admission_policy_seq = 0
        self._stop = threading.Event()
        self._loop = threading.Thread(
            target=self._control_loop, name="serve_control", daemon=True)
        self._loop.start()

    # -- deploy API ---------------------------------------------------
    def deploy(self, name: str, deployment, init_args, init_kwargs,
               route_prefix: Optional[str] = None,
               app_name: Optional[str] = None) -> None:
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                info = _DeploymentInfo(deployment, init_args, init_kwargs)
                self._deployments[name] = info
            else:
                info.deployment = deployment
                info.init_args = init_args
                info.init_kwargs = init_kwargs
                info.target_num = deployment.num_replicas
                # Version rollout: replace existing replicas.
                self._scale_to(name, info, 0)
            if route_prefix:
                self._routes[route_prefix] = name
            if app_name:
                self._apps[app_name] = name
            self._reconcile_one(name, info)

    def scale_deployment(self, name: str, num_replicas: int) -> int:
        """Imperative scale: pin the deployment's target replica count
        and reconcile now. A downscale runs the same drain path as
        autoscaling — for ``migrate_prefixes`` fleets the victim's warm
        radix-trie chains are exported to a survivor before the kill."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                raise KeyError(f"no deployment named {name!r}")
            info.target_num = max(0, int(num_replicas))
            # pin against the autoscaler immediately re-deciding
            info._last_scale_up = info._last_scale_down = time.time()
            self._reconcile_one(name, info)
            return len(info.replicas)

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            info = self._deployments.pop(name, None)
            if info is not None:
                self._scale_to(name, info, 0)
            self._routes = {r: d for r, d in self._routes.items()
                            if d != name}
            self._disagg_routes = {
                r: pair for r, pair in self._disagg_routes.items()
                if name not in pair.values()}

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            for name, info in list(self._deployments.items()):
                self._scale_to(name, info, 0)
            self._deployments.clear()
            self._routes.clear()
            self._disagg_routes.clear()

    # -- handle/proxy API ---------------------------------------------
    def get_version(self, name: str) -> int:
        with self._lock:
            info = self._deployments.get(name)
            return info.version if info else -1

    def get_membership(self, name: str):
        """Atomic (version, replicas) snapshot — handles must never see
        a replica list from a different version than they cache."""
        with self._lock:
            info = self._deployments.get(name)
            if info is None:
                return -1, []
            return info.version, list(info.replicas)

    def get_replicas(self, name: str) -> List[Any]:
        return self.get_membership(name)[1]

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def get_routes_info(self) -> Dict[str, Dict[str, Any]]:
        """Route table with per-deployment HTTP dispatch flags: the
        proxy picks unary / generator-streaming / ASGI per route
        (reference: proxy asks the controller for app configs)."""
        import inspect
        with self._lock:
            out = {}
            for prefix, name in self._routes.items():
                info = self._deployments.get(name)
                asgi = streaming = False
                if info is not None:
                    fc = info.deployment.func_or_class
                    asgi = bool(getattr(fc, "__serve_asgi__", False))
                    target = fc if not isinstance(fc, type) else \
                        getattr(fc, "__call__", None)
                    streaming = bool(
                        target is not None and (
                            inspect.isgeneratorfunction(target)
                            or inspect.isasyncgenfunction(target)))
                out[prefix] = {"name": name, "asgi": asgi,
                               "streaming": streaming}
            for prefix, pair in self._disagg_routes.items():
                out[prefix] = {"name": pair["decode"], "asgi": False,
                               "streaming": True, "disagg": dict(pair)}
            return out

    def register_disagg_route(self, route_prefix: str, prefill: str,
                              decode: str) -> None:
        """Route HTTP traffic at ``route_prefix`` through the
        disaggregated (prefill, decode) deployment pair."""
        with self._lock:
            if prefill not in self._deployments \
                    or decode not in self._deployments:
                raise ValueError(
                    f"disagg route {route_prefix!r} references unknown "
                    f"deployments {prefill!r}/{decode!r}")
            self._disagg_routes[route_prefix] = {
                "prefill": prefill, "decode": decode}

    # -- admission config plane ---------------------------------------
    def set_admission_policy(self, policy: Dict[str, Any]) -> int:
        """Validate and store a fleet-wide admission policy; routers
        with admission enabled pick it up on their next poll. Returns
        the new seq so callers can confirm propagation."""
        from ray_tpu_torch.serve.admission import AdmissionPolicy
        p = AdmissionPolicy.from_dict(policy)  # ValueError on bad knobs
        with self._lock:
            self._admission_policy = p.to_dict()
            self._admission_policy_seq += 1
            return self._admission_policy_seq

    def get_admission_policy(self):
        """(seq, policy dict | None); seq 0 = never configured."""
        with self._lock:
            d = self._admission_policy
            return self._admission_policy_seq, \
                dict(d) if d is not None else None

    def get_app_ingress(self, app_name: str) -> Optional[str]:
        with self._lock:
            return self._apps.get(app_name)

    def app_has_method(self, app_name: str, method: str) -> bool:
        """Whether the app's ingress deployment defines ``method`` — the
        gRPC proxy maps user-service RPC names onto deployment methods
        (reference: serve's gRPC ingress method routing)."""
        if method.startswith("_"):
            return False
        with self._lock:
            name = self._apps.get(app_name)
            info = self._deployments.get(name) if name else None
            if info is None:
                return False
            fc = info.deployment.func_or_class
            return isinstance(fc, type) and callable(
                getattr(fc, method, None))

    def list_applications(self) -> List[str]:
        with self._lock:
            return sorted(self._apps)

    def list_deployments(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{
                "name": name,
                "num_replicas": len(info.replicas),
                "target_num_replicas": info.target_num,
                "autoscaling": info.deployment.autoscaling_config
                is not None,
            } for name, info in self._deployments.items()]

    # -- reconciliation -----------------------------------------------
    def _make_replica(self, name: str, info: _DeploymentInfo):
        d = info.deployment
        opts: Dict[str, Any] = {"max_concurrency":
                                max(2, d.max_ongoing_requests)}
        rao = dict(d.ray_actor_options)
        opts["num_cpus"] = float(rao.pop("num_cpus", 1.0))
        if "num_gpus" in rao:
            opts["num_gpus"] = float(rao.pop("num_gpus"))
        if "resources" in rao:
            opts["resources"] = rao.pop("resources")
        replica_id = f"{name}#{info.replica_counter}"
        info.replica_counter += 1
        actor_cls = ray_tpu_torch.remote(**opts)(Replica)
        return actor_cls.remote(
            d.func_or_class, info.init_args, info.init_kwargs,
            d.user_config, name, replica_id)

    def _scale_to(self, name: str, info: _DeploymentInfo, n: int) -> None:
        while len(info.replicas) > n:
            replica = info.replicas.pop()
            if info.replicas and getattr(
                    info.deployment, "migrate_prefixes", False):
                # warm-prefix migration: drain the victim's warm
                # radix-trie KV chains into a survivor before the kill,
                # worker-to-worker (the export ref rides straight into
                # the import call). Strictly best-effort and bounded —
                # a wedged victim must never stall the downscale.
                try:
                    ref = replica.prepare_drain.remote(1, 0)
                    survivor = info.replicas[-1]
                    ray_tpu_torch.get(survivor.handle_request.remote(
                        "import_warm_prefixes", ref), timeout=5)
                except Exception:
                    pass
            try:
                ray_tpu_torch.kill(replica)
            except Exception:
                pass
            info.version += 1
        while len(info.replicas) < n:
            info.replicas.append(self._make_replica(name, info))
            info.version += 1

    def _reconcile_one(self, name: str, info: _DeploymentInfo) -> None:
        self._scale_to(name, info, info.target_num)

    def _control_loop(self) -> None:
        tick = 0
        while not self._stop.wait(0.5):
            tick += 1
            try:
                with self._lock:
                    items = list(self._deployments.items())
                for name, info in items:
                    if tick % 6 == 0:  # health probe ~every 3s
                        self._health_check(name, info)
                    self._autoscale(name, info)
                    with self._lock:
                        self._reconcile_one(name, info)
            except Exception:
                pass  # the loop must survive transient errors

    def _health_check(self, name: str, info: _DeploymentInfo) -> None:
        dead = []
        for replica in info.replicas:
            try:
                ray_tpu_torch.get(replica.check_health.remote(), timeout=30)
            except Exception:
                dead.append(replica)
        if dead:
            with self._lock:
                for replica in dead:
                    if replica in info.replicas:
                        info.replicas.remove(replica)
                        info.version += 1
                    try:
                        ray_tpu_torch.kill(replica)
                    except Exception:
                        pass
            # _reconcile_one (caller) restarts replacements.

    def _autoscale(self, name: str, info: _DeploymentInfo) -> None:
        cfg = info.deployment.autoscaling_config
        if cfg is None or not info.replicas:
            return
        try:
            ongoing = ray_tpu_torch.get(
                [r.num_ongoing_requests.remote() for r in info.replicas],
                timeout=10)
        except Exception:
            return
        avg = sum(ongoing) / len(ongoing)
        avg_queue = avg_ttft = None
        if cfg.target_queue_depth is not None \
                or cfg.target_ttft_s is not None:
            # engine-gauge probe (serve_engine_queue_depth / ttft): the
            # per-replica scheduler counters surfaced by Replica.stats
            try:
                stats = ray_tpu_torch.get(
                    [r.stats.remote() for r in info.replicas], timeout=10)
            except Exception:
                stats = []
            queues = [s["engine"].get("queue_depth") for s in stats
                      if isinstance(s, dict) and "engine" in s]
            ttfts = [s["engine"].get("ttft_ewma_s") for s in stats
                     if isinstance(s, dict) and "engine" in s]
            queues = [q for q in queues if q is not None]
            ttfts = [t for t in ttfts if t is not None]
            if queues:
                avg_queue = sum(queues) / len(queues)
            if ttfts:
                avg_ttft = sum(ttfts) / len(ttfts)
        new_target = autoscale_decision(cfg, info.target_num, avg,
                                        avg_queue, avg_ttft)
        now = time.time()
        if new_target > info.target_num and \
                now - info._last_scale_up > cfg.upscale_delay_s:
            info.target_num = new_target
            info._last_scale_up = now
        elif new_target < info.target_num and \
                now - info._last_scale_down > cfg.downscale_delay_s:
            info.target_num = new_target
            info._last_scale_down = now
