"""GKE/KubeRay-shaped node provider: joins the autoscaler to a
Kubernetes-managed TPU fleet.

Reference: ``python/ray/autoscaler/_private/kuberay/node_provider.py``
(KubeRayNodeProvider — the autoscaler never creates cloud instances
itself; it PATCHes the RayCluster custom resource's
``workerGroupSpecs[i].replicas`` and lets the KubeRay operator reconcile
pods, scaling down via the ``workersToDelete`` protocol so the operator
deletes the *specific* pods the autoscaler drained).

TPU-native mapping, consistent with :mod:`ray_tpu_torch.autoscaler.gce`: one
provider node is one TPU pod SLICE — here one replica of a worker group
whose pod template requests a ``google.com/tpu`` node-pool. A
``v5litepod-64`` demand bumps one workergroup's replicas by one; the
operator schedules the slice's host pods, which run ``ray-tpu start``
and join the cluster carrying the provider-node label.

The REST transport is injectable (``request_fn``) so tests drive the
full provider against a mock of the Kubernetes API; the production
default reads the in-cluster service-account token.

The port's copy of ``ray_tpu/autoscaler/gke.py``: the custom resource,
its labels and the ``workersToDelete`` protocol are kept as they are; a
group's resources come from its config, where the port's hosts name
their accelerator count ``GPU``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

#: pod labels the operator stamps / the provider filters on (KubeRay's
#: ray.io/* label family, TPU-native names)
LABEL_CLUSTER = "ray-tpu/cluster"
LABEL_GROUP = "ray-tpu/group"
LABEL_NODE_ID = "ray-tpu/node-id"

GROUP_VERSION = "ray-tpu.io/v1"
PLURAL = "raytpuclusters"


class K8sApiError(RuntimeError):
    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


class K8sApiClient:
    """Minimal Kubernetes REST client (in-cluster auth).

    ``request_fn(method, path, body_dict_or_None) -> dict`` is the whole
    transport; tests inject a fake. ``path`` is the API path relative to
    the apiserver root (e.g. ``/api/v1/namespaces/x/pods``).
    """

    def __init__(self, namespace: str,
                 request_fn: Optional[Callable[..., dict]] = None,
                 host: str = "https://kubernetes.default.svc",
                 sleep_fn: Callable[[float], None] = time.sleep,
                 max_retries: int = 5):
        self.namespace = namespace
        self.host = host
        self._request = request_fn or self._urllib_request
        self._sleep = sleep_fn
        self._max_retries = max_retries
        self._token: Optional[str] = None
        self._rng = __import__("random").Random()

    def _get_token(self) -> str:
        if self._token is None:
            with open(f"{SA_DIR}/token") as f:
                self._token = f.read().strip()
        return self._token

    def _urllib_request(self, method: str, path: str,
                        body: Optional[dict]) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        content_type = "application/json"
        if method == "PATCH":
            # RFC 6902 JSON patch: what KubeRay's autoscaler uses for
            # replicas/workersToDelete updates
            content_type = "application/json-patch+json"
        attempt = 0
        while True:
            req = urllib.request.Request(
                self.host + path, data=data, method=method,
                headers={"Authorization": f"Bearer {self._get_token()}",
                         "Content-Type": content_type})
            try:
                import ssl
                ctx = ssl.create_default_context(cafile=f"{SA_DIR}/ca.crt")
                with urllib.request.urlopen(req, timeout=60,
                                            context=ctx) as resp:
                    payload = resp.read()
                return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:500]
                if e.code not in (429, 500, 502, 503, 504) \
                        or attempt >= self._max_retries:
                    raise K8sApiError(
                        f"k8s API {method} {path} -> {e.code}: {detail}",
                        status=e.code) from e
            except urllib.error.URLError as e:
                if attempt >= self._max_retries:
                    raise K8sApiError(
                        f"k8s API {method} {path} unreachable: "
                        f"{e.reason}") from e
            # shared retry shape (util/backoff.py): same envelope as
            # the historical inline formula — equal jitter, base 1s,
            # 30s cap
            from ray_tpu_torch.util.backoff import backoff_delay
            self._sleep(backoff_delay(attempt, base=1.0, cap=30.0,
                                      jitter="equal", rng=self._rng))
            attempt += 1

    # ----------------------------------------------------------- objects
    def get_cluster_cr(self, name: str) -> dict:
        return self._request(
            "GET", f"/apis/{GROUP_VERSION}/namespaces/{self.namespace}"
                   f"/{PLURAL}/{name}", None)

    def patch_cluster_cr(self, name: str, patch: List[dict]) -> dict:
        return self._request(
            "PATCH", f"/apis/{GROUP_VERSION}/namespaces/{self.namespace}"
                     f"/{PLURAL}/{name}", patch)

    def list_pods(self, label_selector: str) -> List[dict]:
        out: List[dict] = []
        token = ""
        while True:
            path = (f"/api/v1/namespaces/{self.namespace}/pods"
                    f"?labelSelector={label_selector}")
            if token:
                path += f"&continue={token}"
            resp = self._request("GET", path, None)
            out.extend(resp.get("items", []))
            token = (resp.get("metadata") or {}).get("continue") or ""
            if not token:
                return out


class GKETPUNodeProvider(NodeProvider):
    """NodeProvider over KubeRay-style worker groups of TPU slices.

    provider_config keys:
      namespace, cluster_name     — the RayTPUCluster CR to drive
      groups: {node_type: group}  — worker-group name per node type (the
                                    CR's workerGroupSpecs[].groupName)
      resources: {node_type: {..}} — slice-level resources per type
    """

    def __init__(self, provider_config: Dict[str, Any],
                 api: Optional[K8sApiClient] = None,
                 resolve_internal: Optional[
                     Callable[[str], List[bytes]]] = None):
        super().__init__(provider_config)
        self.namespace = provider_config["namespace"]
        self.cluster_name = provider_config["cluster_name"]
        self.api = api or K8sApiClient(self.namespace)
        self.groups: Dict[str, str] = dict(
            provider_config.get("groups", {}))
        self._type_by_group = {g: t for t, g in self.groups.items()}
        self._resources: Dict[str, Dict[str, float]] = {
            k: dict(v)
            for k, v in (provider_config.get("resources") or {}).items()}
        self._resolve_internal = resolve_internal or (lambda _nid: [])
        self._lock = threading.Lock()
        #: node_id -> {type, group}; includes replicas we bumped whose
        #: pods have not appeared yet (pending inventory, so demand that
        #: a booting slice will absorb doesn't double-launch)
        self._meta: Dict[str, dict] = {}
        self._creating: Dict[str, float] = {}
        self._pods_cache: Optional[List[dict]] = None
        self._pods_cache_at = 0.0
        self.pods_cache_ttl_s = float(
            provider_config.get("pods_cache_ttl_s", 5.0))
        #: (slice id, annotation) pairs already reported as drains
        self._maintenance_seen: set = set()

    # ------------------------------------------------------------ helpers
    def _group_index(self, cr: dict, group: str) -> int:
        specs = cr.get("spec", {}).get("workerGroupSpecs", [])
        for i, s in enumerate(specs):
            if s.get("groupName") == group:
                return i
        raise KeyError(f"worker group {group!r} not in CR "
                       f"{self.cluster_name} (has "
                       f"{[s.get('groupName') for s in specs]})")

    def _cluster_pods(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            if self._pods_cache is not None and \
                    now - self._pods_cache_at < self.pods_cache_ttl_s:
                return self._pods_cache
        sel = f"{LABEL_CLUSTER}={self.cluster_name}"
        pods = self.api.list_pods(sel)
        live = [p for p in pods
                if (p.get("status", {}).get("phase")
                    in ("Pending", "Running"))
                and not p.get("metadata", {}).get("deletionTimestamp")]
        with self._lock:
            self._pods_cache = live
            self._pods_cache_at = now
            for p in live:
                labels = p["metadata"].get("labels", {})
                nid = labels.get(LABEL_NODE_ID)
                if nid:
                    self._creating.pop(nid, None)
                    if nid not in self._meta:
                        # pods carry the GROUP label; map back to the
                        # configured node TYPE (a restarted provider
                        # rediscovering slices must type them correctly
                        # or the autoscaler double-launches)
                        group = labels.get(LABEL_GROUP, "")
                        self._meta[nid] = {
                            "type": self._type_by_group.get(group,
                                                            group),
                            "group": group}
        return live

    def _invalidate_pods(self) -> None:
        with self._lock:
            self._pods_cache = None

    # ------------------------------------------------------------ listing
    def non_terminated_nodes(self) -> List[str]:
        pods = self._cluster_pods()
        listed = []
        seen = set()
        for p in pods:
            nid = p["metadata"].get("labels", {}).get(LABEL_NODE_ID)
            if nid and nid not in seen:
                seen.add(nid)
                listed.append(nid)
        with self._lock:
            pending = [nid for nid in self._creating if nid not in seen]
        return listed + pending

    def node_type(self, node_id: str) -> str:
        with self._lock:
            meta = self._meta.get(node_id)
        if meta is None:
            raise KeyError(f"unknown provider node {node_id}")
        return meta["type"]

    def node_resources(self, node_id: str) -> Dict[str, float]:
        return dict(self._resources.get(self.node_type(node_id), {}))

    # ----------------------------------------------------------- creation
    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        """Scale the node type's worker group up by one replica. The
        operator creates the slice's pods; they carry our node-id label
        via the group's pod template (the CR templating substitutes
        the per-replica node id, mirroring KubeRay's replica hostnames).
        """
        group = self.groups.get(node_type)
        if group is None:
            raise KeyError(
                f"no worker group for node type {node_type!r} "
                f"(configured: {sorted(self.groups)})")
        node_id = f"ray-{self.cluster_name}-{node_type}-" \
                  f"{uuid.uuid4().hex[:8]}"
        cr = self.api.get_cluster_cr(self.cluster_name)
        idx = self._group_index(cr, group)
        replicas = int(cr["spec"]["workerGroupSpecs"][idx]
                       .get("replicas", 0))
        self.api.patch_cluster_cr(self.cluster_name, [
            {"op": "replace",
             "path": f"/spec/workerGroupSpecs/{idx}/replicas",
             "value": replicas + 1},
            {"op": "add",
             "path": f"/spec/workerGroupSpecs/{idx}/pendingNodeIds/-",
             "value": node_id},
        ])
        with self._lock:
            self._creating[node_id] = time.monotonic()
            self._meta[node_id] = {"type": node_type, "group": group}
        self._invalidate_pods()
        logger.info("gke: scaled up group %s for %s (replica node %s)",
                    group, node_type, node_id)
        return node_id

    # -------------------------------------------------------- termination
    def terminate_node(self, node_id: str) -> None:
        """KubeRay scale-down protocol: name the node in the group's
        ``workersToDelete`` AND decrement replicas in one patch, so the
        operator removes exactly this slice (not an arbitrary replica).
        Local bookkeeping is dropped only AFTER the API accepted the
        patch — popping first would make a failed terminate permanently
        unretryable (the no-op double-terminate path) and leak the
        slice."""
        with self._lock:
            meta = self._meta.get(node_id)
        if meta is None:
            return
        cr = self.api.get_cluster_cr(self.cluster_name)
        idx = self._group_index(cr, meta["group"])
        spec = cr["spec"]["workerGroupSpecs"][idx]
        replicas = int(spec.get("replicas", 0))
        self.api.patch_cluster_cr(self.cluster_name, [
            {"op": "replace",
             "path": f"/spec/workerGroupSpecs/{idx}/replicas",
             "value": max(0, replicas - 1)},
            {"op": "add",
             "path": f"/spec/workerGroupSpecs/{idx}"
                     f"/scaleStrategy/workersToDelete/-",
             "value": node_id},
        ])
        with self._lock:
            self._meta.pop(node_id, None)
            self._creating.pop(node_id, None)
        self._invalidate_pods()
        logger.info("gke: scaled down %s (group %s)", node_id,
                    meta["group"])

    # ----------------------------------------------------------- identity
    def internal_ids(self, node_id: str) -> List[bytes]:
        return list(self._resolve_internal(node_id))

    def internal_id(self, node_id: str) -> Optional[bytes]:
        ids = self.internal_ids(node_id)
        return ids[0] if ids else None

    def expected_internal_count(self, node_id: str) -> int:
        """Host count = the slice's pods carrying this node id."""
        n = 0
        for p in self._cluster_pods():
            if p["metadata"].get("labels", {}).get(LABEL_NODE_ID) \
                    == node_id:
                n += 1
        return max(1, n)

    # ---- slice-granular API: one workergroup replica IS one slice ----
    def create_slice(self, slice_type: str, topology: str = "",
                     host_resources: Optional[Dict[str, float]] = None
                     ) -> str:
        return self.create_node(
            slice_type,
            dict(host_resources
                 or self._resources.get(slice_type, {})))

    def delete_slice(self, slice_id: str) -> None:
        self.terminate_node(slice_id)

    def slice_hosts(self, slice_id: str) -> List[str]:
        return [p["metadata"].get("name", "")
                for p in self._cluster_pods()
                if p["metadata"].get("labels", {}).get(LABEL_NODE_ID)
                == slice_id]

    def maintenance_events(self) -> List[dict]:
        """Kubernetes drain notices: a pod annotated
        ``ray-tpu/maintenance`` (what a node-drain webhook or the
        operator stamps ahead of TPU maintenance) flags its whole
        slice for a preemption-aware drain. Each (slice, annotation)
        pair is reported once."""
        out: List[dict] = []
        for p in self._cluster_pods():
            md = p.get("metadata", {})
            nid = md.get("labels", {}).get(LABEL_NODE_ID)
            notice = (md.get("annotations") or {}).get(
                "ray-tpu/maintenance")
            if not nid or notice is None:
                continue
            key = (nid, str(notice))
            with self._lock:
                if key in self._maintenance_seen:
                    continue
                self._maintenance_seen.add(key)
            out.append({"slice_id": nid, "kind": "maintenance",
                        "event_id": f"gke-{len(self._maintenance_seen)}"})
        return out
