"""GCE TPU-VM node provider: provisions real TPU pod slices.

Reference: ``python/ray/autoscaler/_private/gcp/node.py:618`` (GCPTPU —
create/list/delete/labels against the Cloud TPU REST API with
long-running-operation polling) and ``gcp/node_provider.py`` (the
NodeProvider plugin joining that API to the autoscaler). The TPU-native
redesign differs structurally: here **one provider node is one TPU pod
slice** — the atomic gang unit the scheduler reasons about
(``TPU-{type}-head`` resources) — never an individual VM, so a
``v5litepod-64`` demand creates exactly one slice whose 16 host VMs all
join the cluster, and termination deletes the whole slice atomically.

The REST transport is injectable (``request_fn``) so tests drive the
full provider against a mock of the TPU API; production default uses
urllib with a GCE metadata-server OAuth token.

The port's copy of ``ray_tpu/autoscaler/gce.py``. The Cloud TPU API, its
names and its labels are kept as they are; a slice's resources come from
the node types' and slices' config, where the port's hosts name their
accelerator count ``GPU`` (as ``slices.py`` and the fake providers do).
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

TPU_API_ROOT = "https://tpu.googleapis.com/v2"
METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                      "instance/service-accounts/default/token")

#: provider-owned labels stamped on every slice we create
LABEL_CLUSTER = "ray-tpu-cluster"
LABEL_NODE_TYPE = "ray-tpu-node-type"
LABEL_NODE_ID = "ray-tpu-node-id"

#: TPU node states that count as "gone" (reference: GCPTPUNode.is_terminated
#: treats anything past READY/CREATING/STARTING/REPAIRING as terminated)
_LIVE_STATES = {"CREATING", "READY", "STARTING", "REPAIRING", "RESTARTING"}


class TPUApiError(RuntimeError):
    """An error surfaced by the Cloud TPU API (HTTP or operation error)."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _default_token_fn() -> Dict[str, Any]:
    """Fetch an access token from the GCE metadata server. Returns the
    raw token payload ({access_token, expires_in, ...})."""
    req = urllib.request.Request(
        METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


#: HTTP statuses worth retrying (reference: gcp/node.py:618's
#: has_retriable_http_code — rate limits and transient server errors)
_RETRYABLE_STATUSES = (429, 500, 502, 503, 504)


class TPUApiClient:
    """Thin REST client for the Cloud TPU v2 API.

    ``request_fn(method, url, body_dict_or_None) -> dict`` is the whole
    transport; tests inject a fake, production uses `_urllib_request` —
    which retries 429/5xx and network errors with exponential backoff +
    jitter, caches the metadata token until shortly before expiry, and
    refreshes it once on a 401 (reference: gcp/node.py retry semantics).
    """

    def __init__(self, project: str, zone: str,
                 request_fn: Optional[Callable[..., dict]] = None,
                 token_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 max_retries: int = 5):
        self.project = project
        self.zone = zone
        self._token_fn = token_fn or _default_token_fn
        self._request = request_fn or self._urllib_request
        self._sleep = sleep_fn
        self._max_retries = max_retries
        self._token: Optional[str] = None
        self._token_expiry = 0.0
        self._rng = __import__("random").Random()

    @property
    def parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    # ------------------------------------------------------------- token
    def _get_token(self) -> str:
        if self._token is None or time.monotonic() >= self._token_expiry:
            payload = self._token_fn()
            if isinstance(payload, str):
                # legacy injectable token_fns return the bare token
                self._token, self._token_expiry = payload, float("inf")
            else:
                self._token = payload["access_token"]
                # refresh 60s early so in-flight requests never carry a
                # token that expires mid-call
                self._token_expiry = time.monotonic() + max(
                    30.0, float(payload.get("expires_in", 3600)) - 60.0)
        return self._token

    def _invalidate_token(self) -> None:
        self._token = None
        self._token_expiry = 0.0

    def _backoff(self, attempt: int) -> None:
        # shared retry shape (util/backoff.py): exponential, capped;
        # equal jitter keeps the floor the transport tests assert on
        from ray_tpu_torch.util.backoff import backoff_delay
        self._sleep(backoff_delay(attempt, base=1.0, cap=30.0,
                                  jitter="equal", rng=self._rng))

    def _urllib_request(self, method: str, url: str,
                        body: Optional[dict]) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        attempt = 0
        refreshed = False
        while True:
            req = urllib.request.Request(
                url, data=data, method=method,
                headers={"Authorization": f"Bearer {self._get_token()}",
                         "Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    payload = resp.read()
                return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:500]
                if e.code == 401 and not refreshed:
                    # token expired server-side (clock skew, revocation):
                    # refresh once and retry immediately
                    refreshed = True
                    self._invalidate_token()
                    continue
                if e.code not in _RETRYABLE_STATUSES \
                        or attempt >= self._max_retries:
                    raise TPUApiError(
                        f"TPU API {method} {url} -> {e.code}: {detail}",
                        status=e.code) from e
                logger.warning("gce: %s %s -> %s (attempt %d); retrying",
                               method, url, e.code, attempt + 1)
            except urllib.error.URLError as e:
                # transport-level failure (DNS, conn reset): retryable
                if attempt >= self._max_retries:
                    raise TPUApiError(
                        f"TPU API {method} {url} unreachable: "
                        f"{e.reason}") from e
                logger.warning("gce: %s %s unreachable (%s, attempt %d);"
                               " retrying", method, url, e.reason,
                               attempt + 1)
            self._backoff(attempt)
            attempt += 1

    # ------------------------------------------------------------ nodes
    def create_node(self, node_id: str, body: dict) -> dict:
        """Returns a long-running operation (reference: nodes.create)."""
        url = f"{TPU_API_ROOT}/{self.parent}/nodes?nodeId={node_id}"
        return self._request("POST", url, body)

    def list_nodes(self) -> List[dict]:
        url = f"{TPU_API_ROOT}/{self.parent}/nodes"
        out: List[dict] = []
        page_token = None
        while True:
            page_url = url + (f"?pageToken={page_token}" if page_token
                              else "")
            resp = self._request("GET", page_url, None)
            out.extend(resp.get("nodes", []))
            page_token = resp.get("nextPageToken")
            if not page_token:
                return out

    def get_node(self, name: str) -> dict:
        return self._request("GET", f"{TPU_API_ROOT}/{name}", None)

    def delete_node(self, name: str) -> dict:
        return self._request("DELETE", f"{TPU_API_ROOT}/{name}", None)

    def get_operation(self, name: str) -> dict:
        return self._request("GET", f"{TPU_API_ROOT}/{name}", None)

    def wait_operation(self, operation: dict, timeout_s: float = 600.0,
                       poll_s: float = 5.0) -> dict:
        """Poll a long-running operation to completion (reference:
        GCPTPU.wait_for_operation). Polling rides the shared jittered
        backoff (util/backoff.py) growing to ``poll_s`` — fast first
        checks for quick operations, de-correlated steady-state polls
        for slow ones — through the injectable ``sleep_fn``."""
        from ray_tpu_torch.util.backoff import ExponentialBackoff
        bo = ExponentialBackoff(base=min(1.0, poll_s), cap=poll_s,
                                jitter="equal", rng=self._rng)
        deadline = time.monotonic() + timeout_s
        op = operation
        while not op.get("done"):
            if time.monotonic() > deadline:
                raise TPUApiError(
                    f"operation {op.get('name')} timed out "
                    f"after {timeout_s}s")
            self._sleep(bo.next_delay())
            op = self.get_operation(op["name"])
        if "error" in op:
            # surface the operation metadata alongside the error: the
            # TPU API puts the target node + verb there, which is what
            # an operator needs to act on the failure
            meta = op.get("metadata") or {}
            ctx = ", ".join(f"{k}={meta[k]}" for k in
                            ("target", "verb", "apiVersion") if k in meta)
            raise TPUApiError(
                f"operation {op.get('name')} failed: {op['error']}"
                + (f" ({ctx})" if ctx else ""))
        return op


class GCETPUNodeProvider(NodeProvider):
    """NodeProvider over TPU pod slices.

    provider_config keys:
      project, zone, cluster_name       — identity
      node_configs: {node_type: body}   — per-type TPU node body template
                                          (acceleratorType, runtimeVersion,
                                          extra API fields)
      resources: {node_type: {..}}      — slice-level resources per type
      head_address                      — cluster head host:port baked
                                          into each slice's startup script
      startup_script                    — optional template; '{head}' and
                                          '{node_type}' are substituted
    """

    def __init__(self, provider_config: Dict[str, Any],
                 api: Optional[TPUApiClient] = None,
                 resolve_internal: Optional[
                     Callable[[str], List[bytes]]] = None):
        super().__init__(provider_config)
        self.project = provider_config["project"]
        self.zone = provider_config["zone"]
        self.cluster_name = provider_config["cluster_name"]
        self.api = api or TPUApiClient(self.project, self.zone)
        self.node_configs: Dict[str, dict] = dict(
            provider_config.get("node_configs", {}))
        self._resources: Dict[str, Dict[str, float]] = {
            k: dict(v)
            for k, v in (provider_config.get("resources") or {}).items()}
        # joins provider slices to controller NodeIDs; the launcher wires
        # this to the state API (workers register with a
        # provider-node-id label), tests inject directly
        self._resolve_internal = resolve_internal or (lambda _nid: [])
        self._lock = threading.Lock()
        #: node_id -> pending create operation (counted as live inventory
        #: so the autoscaler doesn't double-launch while a slice boots)
        self._creating: Dict[str, dict] = {}
        self._meta: Dict[str, dict] = {}   # node_id -> {type, name}
        self._list_cache: Optional[List[dict]] = None
        self._list_cache_at = 0.0
        self.list_cache_ttl_s = float(
            provider_config.get("list_cache_ttl_s", 5.0))
        #: (slice id, notice) pairs already reported as drain events
        self._maintenance_seen: set = set()

    # ----------------------------------------------------------- listing
    def _list_cluster_nodes(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            if self._list_cache is not None and \
                    now - self._list_cache_at < self.list_cache_ttl_s:
                return self._list_cache
        nodes = [
            n for n in self.api.list_nodes()
            if n.get("labels", {}).get(LABEL_CLUSTER) == self.cluster_name
            and n.get("state", "READY") in _LIVE_STATES]
        with self._lock:
            self._list_cache = nodes
            self._list_cache_at = now
            # a listed slice is no longer only "creating"
            listed = {n["labels"].get(LABEL_NODE_ID) for n in nodes}
            for nid in list(self._creating):
                if nid in listed:
                    del self._creating[nid]
            for n in nodes:
                nid = n["labels"].get(LABEL_NODE_ID)
                if nid and nid not in self._meta:
                    self._meta[nid] = {
                        "type": n["labels"].get(LABEL_NODE_TYPE, ""),
                        "name": n["name"]}
        return nodes

    def _invalidate(self) -> None:
        with self._lock:
            self._list_cache = None

    def non_terminated_nodes(self) -> List[str]:
        listed = [n["labels"][LABEL_NODE_ID]
                  for n in self._list_cluster_nodes()
                  if n.get("labels", {}).get(LABEL_NODE_ID)]
        with self._lock:
            pending = [nid for nid in self._creating
                       if nid not in listed]
        return listed + pending

    def node_type(self, node_id: str) -> str:
        with self._lock:
            meta = self._meta.get(node_id)
        if meta is None:
            raise KeyError(f"unknown provider node {node_id}")
        return meta["type"]

    def node_resources(self, node_id: str) -> Dict[str, float]:
        return dict(self._resources.get(self.node_type(node_id), {}))

    # ---------------------------------------------------------- creation
    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> str:
        """Create ONE pod slice for ``node_type``. Asynchronous: returns
        as soon as the API accepts the create; the slice shows up in
        inventory immediately (pending) so demand it will absorb doesn't
        trigger duplicate launches."""
        template = self.node_configs.get(node_type)
        if template is None:
            raise KeyError(
                f"no node_config for node type {node_type!r} "
                f"(configured: {sorted(self.node_configs)})")
        node_id = f"ray-{self.cluster_name}-{node_type}-" \
                  f"{uuid.uuid4().hex[:8]}"
        body = dict(template)
        labels = dict(body.get("labels", {}))
        labels.update({LABEL_CLUSTER: self.cluster_name,
                       LABEL_NODE_TYPE: node_type,
                       LABEL_NODE_ID: node_id})
        body["labels"] = labels
        # external IPs are required for SSH (reference:
        # GCPTPU.create_instance sets networkConfig.enableExternalIps)
        net = dict(body.get("networkConfig", {}))
        net.setdefault("enableExternalIps", True)
        body["networkConfig"] = net
        script = self.provider_config.get("startup_script")
        if script:
            md = dict(body.get("metadata", {}))
            md["startup-script"] = script.format(
                head=self.provider_config.get("head_address", ""),
                node_type=node_type, node_id=node_id)
            body["metadata"] = md
        op = self.api.create_node(node_id, body)
        with self._lock:
            self._creating[node_id] = op
            self._meta[node_id] = {
                "type": node_type,
                "name": f"{self.api.parent}/nodes/{node_id}"}
        self._invalidate()
        logger.info("gce: creating TPU slice %s (%s)", node_id, node_type)
        return node_id

    def wait_until_ready(self, node_id: str,
                         timeout_s: float = 900.0) -> dict:
        """Block until the slice reaches READY (used by `ray-tpu up` for
        the head; the autoscaler never blocks here)."""
        with self._lock:
            op = self._creating.get(node_id)
            meta = self._meta.get(node_id)
        if meta is None:
            raise KeyError(f"unknown provider node {node_id}")
        if op is not None:
            self.api.wait_operation(op, timeout_s=timeout_s)
        from ray_tpu_torch.util.backoff import ExponentialBackoff
        bo = ExponentialBackoff(base=1.0, cap=5.0, jitter="equal")
        deadline = time.monotonic() + timeout_s
        while True:
            node = self.api.get_node(meta["name"])
            if node.get("state") == "READY":
                self._invalidate()
                return node
            if node.get("state") not in _LIVE_STATES:
                raise TPUApiError(
                    f"slice {node_id} entered state {node.get('state')}")
            if time.monotonic() > deadline:
                raise TPUApiError(f"slice {node_id} not READY "
                                  f"after {timeout_s}s")
            # jittered poll through the API client's injectable sleep
            # (tests never really wait; real runs don't sync-poll)
            self.api._sleep(bo.next_delay())

    # ------------------------------------------------------- termination
    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            meta = self._meta.pop(node_id, None)
            self._creating.pop(node_id, None)
        if meta is None:
            return
        try:
            self.api.delete_node(meta["name"])
        except TPUApiError as e:
            if e.status != 404:
                raise
        self._invalidate()
        logger.info("gce: deleted TPU slice %s", node_id)

    # ---------------------------------------------------------- identity
    def internal_ids(self, node_id: str) -> List[bytes]:
        """Controller NodeIDs of every host VM in the slice (a
        v5litepod-64 slice has 16) — empty until the hosts register."""
        return list(self._resolve_internal(node_id))

    def internal_id(self, node_id: str) -> Optional[bytes]:
        ids = self.internal_ids(node_id)
        return ids[0] if ids else None

    def expected_internal_count(self, node_id: str) -> int:
        """Host-VM count of the slice, from the API's networkEndpoints
        (authoritative once the slice exists; 1 before it's listed)."""
        eps = self.host_endpoints(node_id)
        return max(1, len(eps))

    def host_endpoints(self, node_id: str) -> List[dict]:
        """The slice's host VM endpoints (ip/port) for command running."""
        for n in self._list_cluster_nodes():
            if n.get("labels", {}).get(LABEL_NODE_ID) == node_id:
                return list(n.get("networkEndpoints", []))
        return []

    # ---- slice-granular API: one provider node IS one pod slice ----
    def create_slice(self, slice_type: str, topology: str = "",
                     host_resources: Optional[Dict[str, float]] = None
                     ) -> str:
        return self.create_node(
            slice_type,
            dict(host_resources or self._resources.get(slice_type, {})))

    def delete_slice(self, slice_id: str) -> None:
        self.terminate_node(slice_id)

    def slice_hosts(self, slice_id: str) -> List[str]:
        eps = self.host_endpoints(slice_id)
        return [e.get("ipAddress") or f"{slice_id}-host{i}"
                for i, e in enumerate(eps)]

    def maintenance_events(self) -> List[dict]:
        """Upcoming-maintenance drain notices from the node listing:
        the TPU API surfaces scheduled host maintenance on the node
        body (``upcomingMaintenance``) and self-repair as the
        REPAIRING state — either one means the slice's hosts are about
        to bounce, so the SliceManager drains proactively. Each
        (slice, notice) pair is reported once; the parsed window
        fields (:func:`parse_upcoming_maintenance`) ride on the event
        so a trainer can decide how urgently to quiesce."""
        out: List[dict] = []
        for n in self._list_cluster_nodes():
            nid = n.get("labels", {}).get(LABEL_NODE_ID)
            if not nid:
                continue
            notice = n.get("upcomingMaintenance")
            if notice is None and n.get("state") == "REPAIRING":
                notice = "REPAIRING"
            if notice is None:
                continue
            key = (nid, json.dumps(notice, sort_keys=True)
                   if isinstance(notice, dict) else str(notice))
            with self._lock:
                if key in self._maintenance_seen:
                    continue
                self._maintenance_seen.add(key)
            ev = {"slice_id": nid, "kind": "maintenance",
                  "event_id": f"gce-{len(self._maintenance_seen)}"}
            if isinstance(notice, dict):
                ev.update(parse_upcoming_maintenance(notice))
            out.append(ev)
        return out


def parse_upcoming_maintenance(notice: dict) -> dict:
    """Flatten a TPU-API ``upcomingMaintenance`` body into the fields
    the drain path keys on. The API spells these camelCase
    (``windowStartTime``/``canReschedule``/...); a rename or type drift
    here would silently disable preemption notices, so the shape is
    pinned by a recorded-response fixture test. Missing fields are
    simply omitted — the event stays a valid drain notice either way.
    """
    out: dict = {}
    if notice.get("type") is not None:
        out["maintenance_type"] = str(notice["type"])
    if notice.get("maintenanceStatus") is not None:
        out["maintenance_status"] = str(notice["maintenanceStatus"])
    if notice.get("canReschedule") is not None:
        out["can_reschedule"] = bool(notice["canReschedule"])
    for src, dst in (("windowStartTime", "window_start"),
                     ("windowEndTime", "window_end"),
                     ("latestWindowStartTime", "latest_window_start")):
        if notice.get(src) is not None:
            out[dst] = str(notice[src])
    return out


def state_resolver(provider_node_label: str = LABEL_NODE_ID):
    """Default internal-id resolver: controller nodes carry a
    ``ray-tpu-node-id`` label set by the startup script's
    ``ray-tpu start --labels``; join on it via the live runtime."""
    def resolve(node_id: str) -> List[bytes]:
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            return []
        out = []
        for n in ray_tpu_torch.nodes():
            labels = n.get("labels") or {}
            # dead entries linger in the controller's node table (a
            # restarted host VM re-registers under a fresh NodeID) —
            # only live registrations count toward the slice's hosts
            if labels.get(provider_node_label) == node_id \
                    and n.get("alive"):
                out.append(bytes.fromhex(n["node_id"]))
        return out
    return resolve
